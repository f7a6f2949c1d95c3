"""The rank side of the port's multi-process tests: run in the processes
``parallel.launch.spawn`` starts (gloo on the CPU), so it imports torch and
the port only, never JAX.  Each function takes the numpy inputs the test
made (JAX leaves and draws among them) and returns numpy results; the test
holds them against JAX on its virtual CPU mesh of the same size.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from nonstationary_precip_tpu_torch import interop
from nonstationary_precip_tpu_torch.experiments import spatial_gibbs
from nonstationary_precip_tpu_torch.kernels.base import Scale
from nonstationary_precip_tpu_torch.kernels.gibbs import packed_gibbs_cross
from nonstationary_precip_tpu_torch.kernels.inducing import nystrom_root
from nonstationary_precip_tpu_torch.kernels.stationary import RBF
from nonstationary_precip_tpu_torch.models.gibbs_gp import gibbs_map_loss_batched, gibbs_sparse_sharded_loss
from nonstationary_precip_tpu_torch.parallel import (
    collectives,
    dp_value_and_grad,
    make_mesh,
    make_mesh_2d,
    make_sharded_chunked_mll,
    sharded_cg_mll,
    sharded_cg_posterior,
    sharded_cholesky,
    sharded_cholesky_2d,
    sharded_marginals,
    sharded_mvn_logpdf,
    sharded_posterior_query,
    sharded_posterior_state,
    sharded_sgpr_value_and_grad,
    tile,
)
from nonstationary_precip_tpu_torch.parallel.sharded_cg import packed_gibbs_local_matvec
from nonstationary_precip_tpu_torch.priors.lognormal_process import LogNormalProcess
from nonstationary_precip_tpu_torch.train.optim import fit_minibatched_splits
from nonstationary_precip_tpu_torch.train.vmapped import Stacked, eval_splits, fit_splits

F64 = torch.float64
CPU = torch.device("cpu")


def t64(a, grad=False):
    return torch.tensor(np.asarray(a), dtype=F64, requires_grad=grad)


def _np(t):
    return None if t is None else t.detach().numpy().copy()


def _grads(model, grads) -> dict:
    names = [n for n, p in model.named_parameters() if p.requires_grad]
    return {n: _np(g) for n, g in zip(names, grads)}


def scale_rbf():
    return Scale.create(RBF.create(2, dtype=F64), dtype=F64)


# ---------------------------------------------------------------------------
# tests/test_torch_parallel.py
# ---------------------------------------------------------------------------


def _dp(mesh, c):
    model = interop.deepgp_from_jax(c["leaves"], CPU, F64, num_layers=2)
    n = c["x"].shape[0]

    def loss_fn(m, xb, yb, eps):
        return m.loss(xb, yb, num_data=n, eps=eps)

    eps = [t64(e[mesh.size][mesh.rank]) for e in c["eps"]]
    loss, grads = dp_value_and_grad(loss_fn, mesh)(model, mesh.rows(t64(c["x"])), mesh.rows(t64(c["y"])), eps)
    return {"loss": float(loss), "grads": _grads(model, grads)}


def _predict(mesh, c):
    model = interop.exact_gp_from_jax(c["leaves"], scale_rbf(), CPU, F64)
    x, y = t64(c["x"]), t64(c["y"])

    def predict_fn(m, xs):
        post = m.predictive(x, y, xs)
        return post.mean, post.var

    with torch.no_grad():
        mean, var = sharded_marginals(predict_fn, mesh)(model, t64(c["xs"]))
    return {"mean": _np(mean), "var": _np(var)}


def _sgpr(mesh, c):
    model = interop.sgpr_from_jax(c["leaves"], scale_rbf(), CPU, F64)

    def root_fn(m, x_s):
        return nystrom_root(m.kernel(x_s, m.z), m.kernel(m.z))[0]

    def trace_fn(m, x_s, root):
        return m.kernel.diag(x_s) - torch.sum(root * root, dim=-1)

    loss, grads = sharded_sgpr_value_and_grad(root_fn, trace_fn, mesh)(model, mesh.rows(t64(c["x"])),
                                                                       mesh.rows(t64(c["y"])))
    return {"loss": float(loss), "grads": _grads(model, grads)}


def _gibbs_sparse(mesh, c, scale_correction):
    model = interop.gibbs_sparse_from_jax(c["leaves"], CPU, F64, scale_correction=scale_correction)
    for p in model.parameters():
        p.requires_grad_(True)
    params = list(model.parameters())
    loss = gibbs_sparse_sharded_loss(mesh)(model, mesh.rows(t64(c["x"])), mesh.rows(t64(c["y"])))
    grads = torch.autograd.grad(loss, params)
    return {"loss": float(loss), "grads": _grads(model, grads)}


def _gather_tiles(mesh2, l_t):
    tiles = collectives.all_gather_object(_np(l_t), mesh2, mesh2.axis[0])  # my column, by row
    col = np.concatenate(tiles, axis=0)
    cols = collectives.all_gather_object(col, mesh2, mesh2.axis[1])  # my row, by column
    return np.concatenate(cols, axis=1)


def _chol(mesh, c):
    a = t64(c["a"])
    out = {"chol": _np(collectives.all_gather(sharded_cholesky(mesh, block=c["block"])(mesh.rows(a)), mesh)),
           "logpdf": float(sharded_mvn_logpdf(mesh, block=c["block"])(mesh.rows(a), t64(c["y"])))}
    for grid in c["grids"][mesh.size]:
        mesh2 = make_mesh_2d(*grid)
        out[f"chol2d_{grid[0]}x{grid[1]}"] = _gather_tiles(mesh2, sharded_cholesky_2d(mesh2, block=c["block"])(
            tile(mesh2, a)))
    try:
        sharded_cholesky(mesh, block=c["block"])(mesh.rows(a[:-mesh.size, :-mesh.size]))
        out["chol_indivisible"] = "no error"
    except ValueError as e:
        out["chol_indivisible"] = str(e)
    return out


def _jax_panel(col_full, jb, block):
    """JAX's panel (``parallel/distributed_chol.py:69-80``), the port's
    before F-P8: L_jj⁻¹ formed, the whole column taken as col · L_jj⁻ᵀ,
    diagonal block included, then masked.  A diagonal block that fails
    gives NaN, as JAX's Cholesky does."""
    n = col_full.shape[0]
    l_jj, info = torch.linalg.cholesky_ex(col_full[jb:jb + block])
    l_jj = torch.full_like(l_jj, float("nan")) if int(info) else l_jj
    l_inv = torch.linalg.solve_triangular(l_jj, torch.eye(block, dtype=col_full.dtype), upper=False)
    p_full = col_full @ l_inv.mT
    rowid, colid = torch.arange(n)[:, None], torch.arange(block)[None, :]
    keep = (rowid >= jb) & ~((rowid < jb + block) & (rowid - jb < colid))
    return torch.where(keep, p_full, torch.zeros_like(p_full))


def _chol_fp8(mesh, c):
    """F-P8: the float32 1-D sharded factor of each ill-conditioned input,
    with the port's panel and with JAX's, gathered."""
    from unittest import mock

    from nonstationary_precip_tpu_torch.parallel import distributed_chol

    out = {}
    for jitter, a in c["a"].items():
        a_s = mesh.rows(torch.tensor(a))
        out[f"port_{jitter}"] = _np(collectives.all_gather(sharded_cholesky(mesh, block=c["block"])(a_s), mesh))
        with mock.patch.object(distributed_chol, "_panel", _jax_panel):
            out[f"jax_{jitter}"] = _np(collectives.all_gather(sharded_cholesky(mesh, block=c["block"])(a_s), mesh))
    return out


def _slice(mesh, c):
    models = [interop.gibbs_exact_from_jax(leaves, CPU, F64) for leaves in c["leaves"]]
    x_tr, y_tr, x_te, y_te = ([t64(a) for a in c[k]] for k in ("x_tr", "y_tr", "x_te", "y_te"))
    prior = LogNormalProcess.create(input_dim=2, mean=np.log(0.3), outputscale=1.0, lengthscale=1.3, dtype=F64)
    pre = prior.gram_pre(torch.stack(x_tr))
    res = fit_splits(models, lambda m, a, b, p: m.loss(a, b, p), x_tr, y_tr, Stacked(pre), lr=0.01,
                     num_steps=c["steps"], batched_loss=gibbs_map_loss_batched, mesh=mesh)
    rm, nl = eval_splits(res.model, spatial_gibbs._eval_one(torch.tensor(c["stdy"], dtype=F64)), x_tr, y_tr, x_te,
                         y_te, mesh=mesh)
    out = {"losses": res.losses, "log_ell": _np(res.model.log_ell), "rmse": _np(rm), "nlpd": _np(nl)}
    try:
        fit_splits(models[:3], lambda m, a, b, p: m.loss(a, b, p), x_tr[:3], y_tr[:3],
                   Stacked(tuple(t[:3] for t in pre)), num_steps=1, mesh=mesh)
        out["indivisible"] = "no error"
    except ValueError as e:
        out["indivisible"] = str(e)
    return out


def _minibatched(mesh, c):
    models = [interop.deepgp_from_jax(leaves, CPU, F64, num_layers=2) for leaves in c["leaves"]]
    n = c["xs"][0].shape[0]

    def loss_fn(m, e, xb, yb):
        return m.loss(xb, yb, num_data=n, eps=e)

    eps = [tuple(t64(a) for a in e) for e in c["eps"]]
    res = fit_minibatched_splits(models, loss_fn, [t64(a) for a in c["xs"]], [t64(a) for a in c["ys"]], eps,
                                 num_epochs=c["epochs"], batch_size=c["batch"], lr=0.01, mesh=mesh)
    return {"losses": res.losses, "params": {n: _np(p) for n, p in res.model.named_parameters()}}


def parallel_cases(inputs: dict) -> dict:
    """Every case of tests/test_torch_parallel.py on this rank's mesh."""
    mesh = make_mesh()
    out = {"rank": mesh.rank, "size": mesh.size}
    t0 = time.perf_counter()
    out["dp"] = _dp(mesh, inputs["dp"])
    out["predict"] = _predict(mesh, inputs["predict"])
    out["sgpr"] = _sgpr(mesh, inputs["sgpr"])
    for sc in (False, True):
        out[f"gibbs_sparse_{sc}"] = _gibbs_sparse(mesh, inputs[f"gibbs_sparse_{sc}"], sc)
    out["chol"] = _chol(mesh, inputs["chol"])
    out["chol_fp8"] = _chol_fp8(mesh, inputs["chol_fp8"])
    out["slice"] = _slice(mesh, inputs["slice"])
    out["minibatched"] = _minibatched(mesh, inputs["minibatched"])
    out["seconds"] = time.perf_counter() - t0
    return out


def mesh_of(n: int):
    return make_mesh(n)


def skip_a_collective(sleep: float):
    """Rank 0 enters an all-reduce that rank 1 never joins (it sleeps): the
    hang the group timeout and the spawn deadline must turn into a failure."""
    mesh = make_mesh()
    if mesh.rank == 0:
        collectives.psum(torch.ones(3), mesh)
    else:
        time.sleep(sleep)
    return mesh.rank


# ---------------------------------------------------------------------------
# tests/test_torch_sharded_cg.py
# ---------------------------------------------------------------------------


def rbf_kernel(leaves: dict):
    """The port's Scale(RBF(2)) holding a JAX kernel's leaves."""
    kernel = scale_rbf()
    with torch.no_grad():
        for name, p in kernel.named_parameters():
            p.copy_(t64(leaves[name]))
    return kernel


def _noise(c):
    return tuple(t64(a) for a in c["noise"]) if isinstance(c["noise"], tuple) else t64(c["noise"])


def _rbf_mll(mesh, c, grads: bool):
    kernel = rbf_kernel(c["kernel"])
    y, s2 = t64(c["y"], True), t64(c["s2"], True)
    val = sharded_cg_mll(kernel, t64(c["x"]), y, _noise(c), s2, mesh, **c["kw"])
    out = {"val": float(val.detach())}
    if grads:
        g = torch.autograd.grad(val, [*kernel.parameters(), y, s2])
        out["grads"] = {**{n: _np(t) for (n, _), t in zip(kernel.named_parameters(), g)}, "y": _np(g[-2]),
                        "s2": _np(g[-1])}
    return out


def _rbf_post(mesh, c):
    mean, cov = sharded_cg_posterior(rbf_kernel(c["kernel"]), t64(c["x"]), t64(c["y"]), t64(c["xs"]), t64(c["s2"]),
                                     mesh, **c["kw"])
    return {"mean": _np(mean), "cov": _np(cov)}


def _aug_mll(mesh, c, builder=None):
    aug, y, s2 = t64(c["aug"], True), t64(c["y"], True), t64(c["s2"], True)
    info = {}
    val = sharded_cg_mll(None, aug, y, _noise(c), s2, mesh, cross_fn=packed_gibbs_cross(2),
                         local_matvec_builder=builder, info=info, **c["kw"])
    g = torch.autograd.grad(val, [aug, y, s2])
    return {"val": float(val.detach()), "grads": {"aug": _np(g[0]), "y": _np(g[1]), "s2": _np(g[2])},
            "relres": _np(info["relres"])}


def _state_query(mesh, c):
    cross = packed_gibbs_cross(2)
    state = sharded_posterior_state(None, t64(c["aug"]), t64(c["y"]), t64(c["s2"]), mesh, cross_fn=cross,
                                    precond_key=c["pkey"], **c["state_kw"])
    mean, cov, info = sharded_posterior_query(state, t64(c["xt"]), mesh, cross_fn=cross, return_info=True,
                                              **c["query_kw"])
    mean_only, _, info_m = sharded_posterior_query(state, t64(c["xt"]), mesh, cross_fn=cross, mean_only=True,
                                                   return_info=True)
    return {"alpha": _np(state.alpha), "lpc_pp": _np(state.lpc @ state.lpc.T), "alpha_relres": float(state.alpha_relres),
            "mean": _np(mean), "cov": _np(cov), "relres": _np(info["relres"]), "mean_only": _np(mean_only),
            "broke": bool(info["broke"]), "broke_mean_only": bool(info_m["broke"])}


def _chunked(mesh, c):
    mll = make_sharded_chunked_mll(mesh, *c["args"], packed_gibbs_cross(2))
    val, relres, (kg, xg, rg, s2g) = mll.value_and_grad(None, t64(c["aug"]), t64(c["y"]), t64(c["s2"]), _noise(c),
                                                        pkey=c["pkey"])
    return {"val": float(val), "relres": _np(relres), "grads": {"aug": _np(xg), "y": _np(rg), "s2": _np(s2g)},
            "iters": mll.iters}


def _train(mesh, c):
    kernel = rbf_kernel(c["kernel"])
    opt = torch.optim.Adam(kernel.parameters(), lr=0.05)
    vals = []
    for _ in range(c["steps"]):
        opt.zero_grad()
        loss = -sharded_cg_mll(kernel, t64(c["x"]), t64(c["y"]), _noise(c), t64(c["s2"]), mesh, **c["kw"])
        loss.backward()
        opt.step()
        vals.append(float(loss.detach()))
    return {"vals": np.asarray(vals), "params": {n: _np(p) for n, p in kernel.named_parameters()}}


def sharded_cg_cases(inputs: dict) -> dict:
    """Every case of tests/test_torch_sharded_cg.py on this rank's mesh."""
    mesh = make_mesh()
    out = {"rank": mesh.rank, "size": mesh.size}
    t0 = time.perf_counter()
    out["mll"] = _rbf_mll(mesh, inputs["mll"], grads=False)
    out["grads"] = _rbf_mll(mesh, inputs["grads"], grads=True)
    out["post"] = _rbf_post(mesh, inputs["post"])
    out["mll_pre"] = _rbf_mll(mesh, inputs["mll_pre"], grads=False)
    out["grads_pre"] = _rbf_mll(mesh, inputs["grads_pre"], grads=True)
    out["post_pre"] = _rbf_post(mesh, inputs["post_pre"])
    out["gibbs"] = _aug_mll(mesh, inputs["gibbs"])
    out["builder_default"] = _aug_mll(mesh, inputs["builder"])
    out["builder_k2"] = _aug_mll(mesh, inputs["builder"], packed_gibbs_local_matvec(2))
    out["nystrom"] = _aug_mll(mesh, inputs["nystrom"])
    out["state"] = _state_query(mesh, inputs["state"])
    out["chunked"] = _chunked(mesh, inputs["chunked"])
    out["train"] = _train(mesh, inputs["train"])
    c = inputs["mll"]
    try:
        sharded_cg_mll(rbf_kernel(c["kernel"]), t64(c["x"])[:-3], t64(c["y"])[:-3], t64(c["noise"])[:-3],
                       t64(c["s2"]), mesh)
        out["indivisible"] = "no error"
    except ValueError as e:
        out["indivisible"] = str(e)
    out["seconds"] = time.perf_counter() - t0
    return out
