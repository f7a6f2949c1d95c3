"""The port's ``parallel/`` (less ``sharded_cg``, which has its own file)
on gloo process groups of 1, 2 and 4 CPU ranks, against the JAX package's
same functions on virtual CPU meshes of as many devices, in float64.

Each world size is spawned once (``parallel.launch.spawn``, the ranks in
``tests/torch_dist_harness.py``, which imports no JAX), every case in that
one group; the ranks' results come back as numpy.  JAX's results are
pinned in tests/fixtures/jax_parallel_ref.npz by tools/pin_jax_parallel.py
from ``jax_ref_live``, which stays here, with the digest of the inputs,
checked on load; two cases are recomputed live against the fixture at
P = 2 and one at P = 4.  Checked:

* data-parallel DSVI (``dp_value_and_grad``): the loss and every gradient
  against JAX's ``dp_value_and_grad`` with ε drawn from
  ``fold_in(key, axis_index)`` (each rank gets its slice of those draws),
  and against a one-process replay of the P shards with the same ε (the
  mean of the shard losses and gradients, tests/test_infra.py:139-171), so
  a gradient counted P times fails;
* ``sharded_marginals`` (test rows padded to a multiple of P);
* ``sharded_sgpr_value_and_grad`` and ``gibbs_sparse_sharded_loss`` (both
  ``scale_correction``s): value and every gradient;
* ``sharded_cholesky``, ``sharded_cholesky_2d`` (1 × 1; 2 × 1 and 1 × 2;
  2 × 2 and 4 × 1) and ``sharded_mvn_logpdf``, and the divisibility error;
* F-P8: the float32 1-D sharded factor of an ill-conditioned RBF Gram
  within the backward-error bound γ_{N+1}|L||Lᵀ|, where JAX's panel (the
  product with L_jj⁻¹) breaks it;
* ``fit_splits`` / ``eval_splits`` (the Gibbs slice's loss, 4 splits) and
  ``fit_minibatched_splits`` (the deep GP, 4 splits) with ``mesh=``: the
  loss traces, the trained parameters and the metrics, and K % P ≠ 0.

Tolerances: 1e-10 relative (to each array's largest entry) where no
optimiser runs; Adam's trajectories against JAX to 1e-8 (they amplify
rounding, as tests/test_torch_gibbs_slice.py's); every replicated result
the same on every rank, and at P = 2 and 4 the same as at P = 1 to 1e-10.
Budget: ~15–30 s with the three spawns, most of it the groups' run.
"""

from __future__ import annotations

import functools
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.stats
import torch

from nonstationary_precip_tpu.kernels import RBF as JaxRBF
from nonstationary_precip_tpu.kernels import Scale as JaxScale
from nonstationary_precip_tpu.kernels.inducing import nystrom_root as jax_nystrom_root
from nonstationary_precip_tpu.models import DeepGP as JaxDeepGP
from nonstationary_precip_tpu.models import ExactGP as JaxExactGP
from nonstationary_precip_tpu.models import GibbsSparseGP as JaxGibbsSparseGP
from nonstationary_precip_tpu.models.gibbs_gp import GibbsExactGP as JaxGibbsExactGP
from nonstationary_precip_tpu.models.gibbs_gp import gibbs_sparse_sharded_loss as jax_gibbs_sparse_sharded_loss
from nonstationary_precip_tpu.models.sgpr import SGPR as JaxSGPR
from nonstationary_precip_tpu.parallel import dp_value_and_grad as jax_dp_value_and_grad
from nonstationary_precip_tpu.parallel import make_mesh as jax_make_mesh
from nonstationary_precip_tpu.parallel import make_mesh_2d as jax_make_mesh_2d
from nonstationary_precip_tpu.parallel import sharded_cholesky as jax_sharded_cholesky
from nonstationary_precip_tpu.parallel import sharded_cholesky_2d as jax_sharded_cholesky_2d
from nonstationary_precip_tpu.parallel import sharded_marginals as jax_sharded_marginals
from nonstationary_precip_tpu.parallel import sharded_sgpr_value_and_grad as jax_sgpr_vag
from nonstationary_precip_tpu.parallel.distributed_chol import sharded_mvn_logpdf as jax_sharded_mvn_logpdf
from nonstationary_precip_tpu.priors import LogNormalProcess as JaxLogNormalProcess
from nonstationary_precip_tpu.train import metrics as jax_metrics
from nonstationary_precip_tpu.train.optim import fit_minibatched_splits as jax_fit_minibatched_splits
from nonstationary_precip_tpu.train.vmapped import Stacked as JaxStacked
from nonstationary_precip_tpu.train.vmapped import eval_splits as jax_eval_splits
from nonstationary_precip_tpu.train.vmapped import fit_splits as jax_fit_splits

import pinned_refs
from nonstationary_precip_tpu_torch import interop
from nonstationary_precip_tpu_torch.parallel.launch import spawn, start
from nonstationary_precip_tpu_torch.priors.matrix_normal import latent_rbf_row_cov

torch.set_num_threads(1)
TESTS = Path(__file__).resolve().parent
JAX_REF = TESTS / "fixtures" / "jax_parallel_ref.npz"
WORLDS = (1, 2, 4)
RTOL = 1e-10
TRAJ_RTOL = 1e-8
K_SPLITS = 4
GRIDS = {1: [(1, 1)], 2: [(2, 1), (1, 2)], 4: [(2, 2), (4, 1)]}


def jax_leaves(tree) -> dict:
    """A JAX pytree as {dotted path: numpy array}, the form ``interop``
    takes, sequence keys as their index."""
    out = {}
    for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]:
        out[jax.tree_util.keystr(path)[1:].replace("[", ".").replace("]", "").replace("..", ".")] = np.asarray(v)
    return out


def close(got, ref, rtol=RTOL, what=""):
    ref = np.asarray(ref, dtype=float)
    np.testing.assert_allclose(np.asarray(got, dtype=float), ref, rtol=0,
                               atol=rtol * max(np.abs(ref).max(), 1e-300), err_msg=what)


def close_grads(got: dict, ref: dict, rtol=RTOL):
    assert got and set(got) <= set(ref), sorted(set(got) - set(ref))
    for name, g in got.items():
        close(g, ref[name], rtol, name)


def jax_eps(key, num_samples, b):
    """The ε a JAX ``DeepGP.loss`` with two hidden layers draws from
    ``key``: per layer (S, O, B)."""
    out = [[], []]
    for k in jax.random.split(key, num_samples):
        for i in range(2):
            k, sub = jax.random.split(k)
            out[i].append(np.asarray(jax.random.normal(sub, (2, b), dtype=jnp.float64)))
    return [np.stack(e) for e in out]


def jax_deepgp(seed, m):
    """A float64 JAX DeepGP with its leaves moved off their init."""
    model = JaxDeepGP.create(jax.random.PRNGKey(seed), input_dims=2, num_layers=2, num_inducing=m,
                             dtype=jnp.float64)
    rng = np.random.default_rng(seed)
    flat, tree = jax.tree_util.tree_flatten(model)
    out = []
    for a in map(np.asarray, flat):
        if a.ndim == 3 and a.shape[-1] == a.shape[-2]:
            a = a + 0.1 * rng.normal(size=a.shape)
        elif a.ndim != 3:
            a = a + 0.3 * rng.normal(size=a.shape)
        out.append(jnp.asarray(a))
    return jax.tree_util.tree_unflatten(tree, out)


def jax_prior():
    return JaxLogNormalProcess.create(input_dim=2, mean=np.log(0.3), outputscale=1.0, lengthscale=1.3,
                                      dtype=jnp.float64)


# ---------------------------------------------------------------------------
# the cases' inputs, made once
# ---------------------------------------------------------------------------

DP_B, DP_S, DP_KEY = 16, 2, 7
MB_N, MB_BATCH, MB_EPOCHS, MB_S = 12, 6, 2, 2


@functools.cache
def models():
    rng = np.random.default_rng(2020)
    c = {}
    jm = jax_deepgp(3, 6)
    x = rng.normal(size=(DP_B, 2))
    c["dp"] = {"jm": jm, "x": x, "y": np.sin(x[:, 0]) + 0.1 * rng.normal(size=DP_B)}

    x = rng.normal(size=(40, 2))
    gp = JaxExactGP.create(JaxScale.create(JaxRBF.create(2, lengthscale=0.9, dtype=jnp.float64), outputscale=0.7,
                                           dtype=jnp.float64), noise=0.1, mean_type="zero", dtype=jnp.float64)
    c["predict"] = {"jm": gp, "x": x, "y": np.sin(x[:, 0]), "xs": rng.normal(size=(23, 2))}

    x = rng.normal(size=(32, 2))
    sg = JaxSGPR.create(JaxScale.create(JaxRBF.create(2, lengthscale=1.1, dtype=jnp.float64), outputscale=0.8,
                                        dtype=jnp.float64), jnp.asarray(x[::4]), noise=0.1, dtype=jnp.float64)
    c["sgpr"] = {"jm": sg, "x": x, "y": np.sin(x[:, 0])}

    x = rng.normal(size=(24, 2))
    for sc in (False, True):
        gs = JaxGibbsSparseGP.create(jnp.asarray(x[::4]), jax_prior(), noise=0.05, outputscale=0.7,
                                     dtype=jnp.float64)
        gs = gs.replace(log_ell_z=gs.log_ell_z + 0.2 * jnp.asarray(rng.normal(size=(6, 2))), scale_correction=sc)
        c[f"gibbs_sparse_{sc}"] = {"jm": gs, "x": x, "y": np.sin(x[:, 0])}

    n = 128
    r = rng.normal(size=(n, 32))
    c["chol"] = {"a": r @ r.T / 32 + 2.0 * np.eye(n), "y": np.sin(np.arange(n) / 7), "block": 16}

    sl = {"jm": [], "x_tr": [], "y_tr": [], "x_te": [], "y_te": []}
    for _ in range(K_SPLITS):
        x = rng.normal(size=(16, 2))
        y = np.sin(2 * x[:, 0]) + 0.1 * rng.normal(size=16)
        jg = JaxGibbsExactGP.create(jnp.asarray(x[:12]), jax_prior(), noise=0.011, outputscale=0.644,
                                    dtype=jnp.float64)
        sl["jm"].append(jg.replace(log_ell=jg.log_ell + 0.2 * jnp.asarray(rng.normal(size=(12, 2)))))
        for k, v in (("x_tr", x[:12]), ("y_tr", y[:12]), ("x_te", x[12:]), ("y_te", y[12:])):
            sl[k].append(v)
    sl["stdy"], sl["steps"] = 1.3, 4
    c["slice"] = sl

    data = [rng.normal(size=(MB_N, 2)) for _ in range(K_SPLITS)]
    c["minibatched"] = {"jm": [jax_deepgp(30 + k, 4) for k in range(K_SPLITS)], "xs": data,
                        "ys": [np.sin(d[:, 0]) for d in data], "keys": [jax.random.PRNGKey(40 + k)
                                                                       for k in range(K_SPLITS)]}
    return c


def mb_steps():
    return MB_EPOCHS * -(-MB_N // MB_BATCH)


@functools.cache
def port_inputs() -> dict:
    """What the ranks get: numpy only (leaves, data, JAX's ε draws)."""
    c = models()
    key = jax.random.PRNGKey(DP_KEY)
    out = {"dp": {"leaves": jax_leaves(c["dp"]["jm"]), "x": c["dp"]["x"], "y": c["dp"]["y"],
                  # per layer, per world size: the (P, S, O, B/P) draws of each rank's folded key
                  "eps": [{p: np.stack([jax_eps(jax.random.fold_in(key, r), DP_S, DP_B // p)[i] for r in range(p)])
                           for p in WORLDS} for i in range(2)]}}
    out["predict"] = {"leaves": jax_leaves(c["predict"]["jm"]), **{k: c["predict"][k] for k in ("x", "y", "xs")}}
    out["sgpr"] = {"leaves": jax_leaves(c["sgpr"]["jm"]), "x": c["sgpr"]["x"], "y": c["sgpr"]["y"]}
    for sc in (False, True):
        g = c[f"gibbs_sparse_{sc}"]
        out[f"gibbs_sparse_{sc}"] = {"leaves": jax_leaves(g["jm"]), "x": g["x"], "y": g["y"]}
    out["chol"] = {**c["chol"], "grids": GRIDS}
    out["chol_fp8"] = {"a": fp8_inputs(), "block": FP8_BLOCK}
    sl = c["slice"]
    out["slice"] = {"leaves": [jax_leaves(m) for m in sl["jm"]],
                    **{k: sl[k] for k in ("x_tr", "y_tr", "x_te", "y_te", "stdy", "steps")}}
    mb = c["minibatched"]
    eps = [tuple(np.stack(e) for e in zip(*[jax_eps(kt, MB_S, MB_BATCH) for kt in jax.random.split(k, mb_steps())]))
           for k in mb["keys"]]
    out["minibatched"] = {"leaves": [jax_leaves(m) for m in mb["jm"]], "xs": mb["xs"], "ys": mb["ys"], "eps": eps,
                          "epochs": MB_EPOCHS, "batch": MB_BATCH}
    return out


#: F-P8's inputs: the RBF row covariance (ℓ 0.5) of the H prior on a 32 × 32
#: grid of [−2, 2]², N = 1024, in float32 with these jitters (κ₂ 9.4e5 and
#: 8.3e6); potrf factors both.
FP8_JITTERS, FP8_BLOCK = (1e-4, 2e-5), 256


@functools.cache
def fp8_inputs() -> dict:
    g = np.linspace(-2.0, 2.0, 32)
    gx, gy = np.meshgrid(g, g)
    u = latent_rbf_row_cov(torch.tensor(np.stack([gx.ravel(), gy.ravel()], 1), dtype=torch.float32), [0.5, 0.5])
    return {j: (u + j * torch.eye(u.shape[0])).numpy() for j in FP8_JITTERS}


def chol_bound_ratio(l, a) -> float:
    """Largest entrywise |LLᵀ − A| / γ_{N+1}|L||Lᵀ| in float64, A's lower
    triangle symmetrised (Higham, Theorem 10.3, float32's unit roundoff)."""
    l, a = np.asarray(l, dtype=np.float64), np.tril(np.asarray(a, dtype=np.float64))
    a = a + np.tril(a, -1).T
    n = a.shape[0]
    gamma = (n + 1) * 2.0**-24 / (1 - (n + 1) * 2.0**-24)
    return float((np.abs(l @ l.T - a) / (gamma * (np.abs(l) @ np.abs(l).T))).max())


# ---------------------------------------------------------------------------
# JAX on its P-device virtual mesh
# ---------------------------------------------------------------------------


def jax_ref_live(p: int, only=None) -> dict:
    """JAX's results on its P-device virtual mesh, computed now: every case,
    or those named in ``only``."""
    c = models()
    mesh = jax_make_mesh(p)
    ref = {}

    def want(name):
        return only is None or name in only

    if want("dp"):
        key = jax.random.PRNGKey(DP_KEY)
        d = c["dp"]

        def shard_loss(m, xs, ys):
            ks = jax.random.fold_in(key, jax.lax.axis_index("data"))
            return m.loss(ks, xs, ys, num_data=DP_B, num_samples=DP_S)

        loss, g = jax.jit(jax_dp_value_and_grad(shard_loss, mesh))(d["jm"], jnp.asarray(d["x"]), jnp.asarray(d["y"]))
        ref["dp"] = {"loss": float(loss), "grads": jax_leaves(g)}

    if want("predict"):
        d = c["predict"]
        xj, yj = jnp.asarray(d["x"]), jnp.asarray(d["y"])

        def predict_fn(m, x_shard):
            post = m.predictive(xj, yj, x_shard)
            return post.mean, post.var

        mean, var = jax.jit(jax_sharded_marginals(predict_fn, mesh))(d["jm"], jnp.asarray(d["xs"]))
        ref["predict"] = {"mean": np.asarray(mean), "var": np.asarray(var)}

    if want("sgpr"):
        def root_fn(m, x_s):
            return jax_nystrom_root(m.kernel(x_s, m.z), m.kernel(m.z))[0]

        def trace_fn(m, x_s, root):
            return m.kernel.diag(x_s) - jnp.sum(root * root, axis=-1)

        d = c["sgpr"]
        loss, g = jax.jit(jax_sgpr_vag(root_fn, trace_fn, mesh))(d["jm"], jnp.asarray(d["x"]), jnp.asarray(d["y"]))
        ref["sgpr"] = {"loss": float(loss), "grads": jax_leaves(g)}

    for sc in (False, True):
        if want(f"gibbs_sparse_{sc}"):
            d = c[f"gibbs_sparse_{sc}"]
            loss, g = jax.jit(jax.value_and_grad(jax_gibbs_sparse_sharded_loss(mesh)))(d["jm"], jnp.asarray(d["x"]),
                                                                                     jnp.asarray(d["y"]))
            ref[f"gibbs_sparse_{sc}"] = {"loss": float(loss), "grads": jax_leaves(g)}

    if want("chol"):
        d = c["chol"]
        a = jnp.asarray(d["a"])
        ref["chol"] = {"chol": np.asarray(jax.jit(jax_sharded_cholesky(mesh, block=d["block"]))(a)),
                       "logpdf": float(jax.jit(jax_sharded_mvn_logpdf(mesh, block=d["block"]))(a,
                                                                                              jnp.asarray(d["y"])))}
        for grid in GRIDS[p]:
            ref["chol"][f"chol2d_{grid[0]}x{grid[1]}"] = np.asarray(
                jax.jit(jax_sharded_cholesky_2d(jax_make_mesh_2d(*grid), block=d["block"]))(a))

    if want("slice"):
        d = c["slice"]
        res = jax_fit_splits(d["jm"], lambda m, a, b, pc: m.loss(a, b, pc), d["x_tr"], d["y_tr"],
                             JaxStacked(jax.vmap(jax_prior().gram_pre)(jnp.asarray(np.stack(d["x_tr"])))), lr=0.01,
                             num_steps=d["steps"], masks=[m.trainable() for m in d["jm"]], mesh=mesh)

        def eval_fn(m, xtr, ytr, xte, yte):
            pred = m.predictive(xtr, ytr, xte)
            return (jax_metrics.rmse_rescaled(pred.mean, yte, d["stdy"]),
                    jax_metrics.nlpd_joint(pred, yte, d["stdy"]))

        rm, nl = jax_eval_splits(res.model, eval_fn, *(list(map(jnp.asarray, d[k])) for k in ("x_tr", "y_tr", "x_te",
                                                                                              "y_te")), mesh=mesh)
        ref["slice"] = {"losses": np.asarray(res.losses), "log_ell": np.asarray(res.model.log_ell),
                        "rmse": np.asarray(rm), "nlpd": np.asarray(nl)}

    if want("minibatched"):
        d = c["minibatched"]
        res = jax_fit_minibatched_splits(
            d["jm"], lambda m, kk, xb, yb: m.loss(kk, xb, yb, num_data=MB_N, num_samples=MB_S),
            [jnp.asarray(a) for a in d["xs"]], [jnp.asarray(a) for a in d["ys"]], keys=d["keys"],
            num_epochs=MB_EPOCHS, batch_size=MB_BATCH, lr=0.01, seeds=list(range(K_SPLITS)), mesh=mesh)
        ref["minibatched"] = {"losses": np.asarray(res.losses), "params": jax_leaves(res.model)}
    return ref


def inputs_digest() -> str:
    """The digest of every input JAX's side and the ranks get, which a
    fixture keeps from its pinning (``pinned_refs.DIGEST``)."""
    leaves, treedef = jax.tree_util.tree_flatten((models(), port_inputs()))
    return pinned_refs.digest([*leaves, str(treedef)])


@functools.cache
def pinned() -> dict:
    return pinned_refs.load_checked(JAX_REF, inputs_digest())


def jax_ref(p: int) -> dict:
    """JAX's results at P, pinned by tools/pin_jax_parallel.py (the live
    computation, ``jax_ref_live``, takes ~40 s on one idle CPU, several
    times that beside the suite's other workers)."""
    return pinned()[str(p)]


# ---------------------------------------------------------------------------
# the port on P gloo ranks
# ---------------------------------------------------------------------------


def _live_is_pinned(p: int, only: tuple):
    live = pinned_refs.flatten(jax_ref_live(p, only=only))
    ref = pinned_refs.flatten({k: v for k, v in jax_ref(p).items() if k in only})
    assert live and set(live) == set(ref), sorted(set(live) ^ set(ref))
    for k, v in live.items():
        np.testing.assert_allclose(v, ref[k], rtol=0, atol=1e-12 * max(np.abs(ref[k]).max(), 1e-300), err_msg=k)


def test_pinned_jax_reference_is_the_live_one():
    """The pinned JAX results are what the JAX package computes now on these
    inputs: two cases recomputed live at P = 2, to 1e-12 of each array's
    largest entry (the same program on the same CPU; the margin is for
    XLA's thread count).  ``pinned`` checks the inputs' digest on load."""
    _live_is_pinned(2, ("predict", "sgpr"))


def test_pinned_jax_reference_at_four_ranks_is_the_live_one():
    """As above, one cheap case at P = 4, so that a pinned world size
    other than 2 is held to live JAX too."""
    _live_is_pinned(4, ("chol",))


@pytest.fixture(scope="module")
def port(tmp_path_factory):
    """The three groups start together and run while JAX computes."""
    groups = {p: start("torch_dist_harness:parallel_cases", p, args=(port_inputs(),),
                       workdir=tmp_path_factory.mktemp(f"world{p}"), paths=[TESTS], deadline=240, echo=False)
              for p in WORLDS}
    runs = {}

    def run(p: int) -> list:
        if p not in runs:
            runs[p] = groups[p].join()
        return runs[p]

    yield run
    for p, g in groups.items():
        if p not in runs:
            g.join()


def _same_on_every_rank(outs: list, case: str):
    first = outs[0][case]
    for o in outs[1:]:
        _assert_tree_equal(o[case], first, f"rank {o['rank']} {case}")


def _assert_tree_equal(a, b, what):
    if isinstance(b, dict):
        assert set(a) == set(b), what
        for k in b:
            _assert_tree_equal(a[k], b[k], f"{what}.{k}")
    elif isinstance(b, str):
        assert a == b, what
    else:
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b), err_msg=what)


@pytest.mark.parametrize("p", WORLDS)
def test_dp_value_and_grad_matches_jax_and_the_shard_replay(p, port):
    ref = jax_ref(p)["dp"]
    outs = port(p)
    _same_on_every_rank(outs, "dp")
    got = outs[0]["dp"]
    close(got["loss"], ref["loss"], what="loss")
    close_grads(got["grads"], ref["grads"])
    # the one-process replay of the P shards with the same ε
    d = port_inputs()["dp"]
    model = interop.deepgp_from_jax(d["leaves"], torch.device("cpu"), torch.float64, num_layers=2)
    params = [q for q in model.parameters() if q.requires_grad]
    b = DP_B // p
    losses, grads = [], []
    for r in range(p):
        sl = slice(r * b, (r + 1) * b)
        loss = model.loss(torch.tensor(d["x"][sl]), torch.tensor(d["y"][sl]), num_data=DP_B,
                          eps=[torch.tensor(e[p][r]) for e in d["eps"]])
        losses.append(float(loss.detach()))
        grads.append(torch.autograd.grad(loss, params))
    close(got["loss"], np.mean(losses), what="replay loss")
    names = [n for n, q in model.named_parameters() if q.requires_grad]
    for i, name in enumerate(names):
        close(got["grads"][name], sum(g[i] for g in grads).numpy() / p, what=f"replay {name}")


@pytest.mark.parametrize("p", WORLDS)
@pytest.mark.parametrize("case", ["predict", "sgpr", "gibbs_sparse_False", "gibbs_sparse_True", "chol", "slice",
                                  "minibatched"])
def test_matches_jax_on_its_mesh(case, p, port):
    outs = port(p)
    _same_on_every_rank(outs, case)
    got, ref = outs[0][case], jax_ref(p)[case]
    if case == "predict":
        close(got["mean"], ref["mean"], what="mean")
        close(got["var"], ref["var"], what="var")
    elif case in ("sgpr", "gibbs_sparse_False", "gibbs_sparse_True"):
        close(got["loss"], ref["loss"], what="loss")
        close_grads(got["grads"], ref["grads"])
    elif case == "chol":
        for k in ref:
            close(got[k], ref[k], what=k)
        a = port_inputs()["chol"]["a"]
        ref_lp = scipy.stats.multivariate_normal(np.zeros(len(a)), a).logpdf(port_inputs()["chol"]["y"])
        close(got["logpdf"], ref_lp, what="logpdf against scipy")
        np.testing.assert_array_equal(np.triu(got["chol"], 1), 0.0)
        assert "divisible" in got["chol_indivisible"]
    elif case == "slice":
        close(got["losses"], ref["losses"], TRAJ_RTOL, "losses")
        close(got["log_ell"], ref["log_ell"], TRAJ_RTOL, "log_ell")
        close(got["rmse"], ref["rmse"], TRAJ_RTOL, "rmse")
        close(got["nlpd"], ref["nlpd"], TRAJ_RTOL, "nlpd")
        assert got["losses"].shape == (port_inputs()["slice"]["steps"], K_SPLITS)
        assert got["indivisible"] == ("no error" if p == 1 else f"3 splits do not divide over a {p}-device mesh")
    elif case == "minibatched":
        assert got["losses"].shape == (mb_steps(), K_SPLITS)
        close(got["losses"], ref["losses"], TRAJ_RTOL, "losses")
        close_grads(got["params"], ref["params"], TRAJ_RTOL)


@pytest.mark.parametrize("p", [2, 4])
@pytest.mark.parametrize("case", ["predict", "sgpr", "gibbs_sparse_False", "gibbs_sparse_True", "chol", "slice",
                                  "minibatched"])
def test_matches_one_rank(case, p, port):
    """P ranks give P = 1's values and gradients (a P-fold gradient, or a
    ridge on the wrong rows, fails)."""
    got, one = port(p)[0][case], port(1)[0][case]
    for k, ref in one.items():
        if k in ("chol_indivisible", "indivisible") or k.startswith("chol2d"):
            continue
        if isinstance(ref, dict):
            close_grads(got[k], ref)
        else:
            close(got[k], ref, what=k)


@pytest.mark.parametrize("p", WORLDS)
@pytest.mark.parametrize("jitter", FP8_JITTERS)
def test_sharded_cholesky_is_backward_stable_on_an_ill_conditioned_input(jitter, p, port):
    """F-P8: at every P the float32 factor (L_jj on the diagonal block, the
    rows below it by substitution) is within γ_{N+1}|L||Lᵀ| (~0.02 of it),
    as potrf's is; JAX's panel, the product with L_jj⁻¹ on the same input
    and ranks, breaks the bound (~600 and ~4000 times over) or fails."""
    a = fp8_inputs()[jitter]
    assert np.isfinite(np.linalg.cholesky(a.astype(np.float64))).all()
    assert bool(torch.isfinite(torch.linalg.cholesky(torch.tensor(a))).all())
    outs = port(p)
    _same_on_every_rank(outs, "chol_fp8")
    l, old = outs[0]["chol_fp8"][f"port_{jitter}"], outs[0]["chol_fp8"][f"jax_{jitter}"]
    assert l.dtype == np.float32 and np.isfinite(l).all()
    np.testing.assert_array_equal(np.triu(l, 1), 0.0)
    assert chol_bound_ratio(l, a) <= 1.0, chol_bound_ratio(l, a)
    assert not np.isfinite(old).all() or chol_bound_ratio(old, a) > 1.0


def test_hang_guard_fails_within_its_deadline(tmp_path):
    """Rank 1 skips the all-reduce rank 0 waits in: with a 5 s group
    timeout and a 15 s deadline the spawn raises, and does not hang."""
    from datetime import timedelta

    t0 = time.monotonic()
    with pytest.raises((RuntimeError, TimeoutError)):
        spawn("torch_dist_harness:skip_a_collective", 2, args=(60.0,), workdir=tmp_path, paths=[TESTS],
              deadline=15, group_timeout=timedelta(seconds=5), echo=False)
    assert time.monotonic() - t0 < 25


def test_chip_smoke_world_refuses_more_ranks_than_cards(monkeypatch):
    """``chip_smoke.py --world 4`` on a host with two cards raises before it
    builds or runs anything: a smaller world would hold nothing of four's."""
    import chip_smoke

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    with pytest.raises(SystemExit, match="needs 4 cards, this host has 2"):
        chip_smoke.main(["--world", "4"])


def test_refusals(tmp_path):
    """make_mesh with more ranks than the group has, and a CUDA group where
    there is no card, raise."""
    with pytest.raises(RuntimeError, match="make_mesh: need 2 devices, have 1"):
        spawn("torch_dist_harness:mesh_of", 1, args=(2,), workdir=tmp_path / "a", paths=[TESTS], echo=False,
              deadline=60)
    if not torch.cuda.is_available():
        from nonstationary_precip_tpu_torch.parallel import init_world

        with pytest.raises(RuntimeError, match="CUDA is not available"):
            init_world(1, 0, tmp_path / "store", device="cuda")
