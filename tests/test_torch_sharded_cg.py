"""The port's ``parallel/sharded_cg.py`` on gloo process groups of 1, 2 and
4 CPU ranks against the JAX package's on virtual CPU meshes of as many
devices, in float64: the cases of tests/test_sharded_cg.py (the MLL's value,
its kernel, y and σ² gradients, the posterior, each with and without the
pivoted-Cholesky preconditioner, the Gibbs kernel's x gradient through the
packed payload, a few Adam steps, the indivisible N), the local matvec
builder of tests/test_pallas_matvec.py::
test_sharded_mll_local_matvec_builder_matches_default (here K2's plain
version), the Nyström factor, the serving state and query, and the chunked
entry.

Both sides get the same numbers: the JAX side draws its probes from a key
(``rademacher``, or ``sample_precond_probes``'s two normal draws) and the
port gets those draws; the keyed Nyström landmarks are JAX's permutation,
and JAX's ``eigh`` takes the port's sign rule (``lazy_cg.canonical_eigh``)
for the one case whose probes see the factor's signs.  JAX's results are
pinned in tests/fixtures/jax_sharded_cg_ref.npz by tools/pin_jax_parallel.py
from ``jax_ref_live``, which stays here, with the digest of the inputs,
checked on load; two cases are recomputed live against the fixture at
P = 2 and one at P = 4.

Tolerances.  CG is not forward stable (ROADMAP §3): two correct
implementations part past ~10 iterations on rounding alone, so against
JAX the budgets are the ones JAX's own tests hold its sharded path to
against its dense one (the same row dot products, partitioned): 1e-8 on
the converged MLL values and gradients, 1e-6 with the preconditioner (its
factor is built to rounding on each side), 1e-7 on posteriors solved to
1e-13; the Nyström, state and chunked cases run 40–60 iterations to 1e-10
and are held to 1e-7 relative; the local matvec builder's run to 1e-5 of
the materialised row block's (``BUILDER_TOL``).  The port at P = 2 and 4 against itself at
P = 1: 1e-9 relative, where the only difference is the BLAS blocking of
an (N/P, N) row block against the (N, N) one.  Budget: ~20–30 s, most
of it the P = 4 group's run.
"""

from __future__ import annotations

import functools
from pathlib import Path
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nonstationary_precip_tpu.kernels import RBF as JaxRBF
from nonstationary_precip_tpu.kernels import GibbsKernel as JaxGibbsKernel
from nonstationary_precip_tpu.kernels import Scale as JaxScale
from nonstationary_precip_tpu.kernels.gibbs import packed_gibbs_cross as jax_packed_cross
from nonstationary_precip_tpu.parallel import make_mesh as jax_make_mesh
from nonstationary_precip_tpu.parallel import make_sharded_chunked_mll as jax_make_sharded_chunked_mll
from nonstationary_precip_tpu.parallel import sharded_cg_mll as jax_sharded_cg_mll
from nonstationary_precip_tpu.parallel import sharded_cg_posterior as jax_sharded_cg_posterior
from nonstationary_precip_tpu.parallel import sharded_posterior_query as jax_sharded_posterior_query
from nonstationary_precip_tpu.parallel import sharded_posterior_state as jax_sharded_posterior_state

import pinned_refs
from nonstationary_precip_tpu_torch.parallel.launch import start

torch.set_num_threads(1)
TESTS = Path(__file__).resolve().parent
JAX_REF = TESTS / "fixtures" / "jax_sharded_cg_ref.npz"
WORLDS = (1, 2, 4)


def jax_leaves(tree) -> dict:
    out = {}
    for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]:
        out[jax.tree_util.keystr(path)[1:].replace("[", ".").replace("]", "").replace("..", ".")] = np.asarray(v)
    return out


def close(got, ref, rtol, what=""):
    ref = np.asarray(ref, dtype=float)
    np.testing.assert_allclose(np.asarray(got, dtype=float), ref, rtol=0,
                               atol=rtol * max(np.abs(ref).max(), 1e-300), err_msg=what)


def canonical_eigh(w, *a, **k):
    """JAX's ``eigh`` with the port's sign rule."""
    lam, v = _plain_eigh(w, *a, **k)
    lead = jnp.take_along_axis(v, jnp.argmax(jnp.abs(v), axis=0)[None], axis=0)
    return lam, v * jnp.where(lead < 0, -1.0, 1.0).astype(v.dtype)


_plain_eigh = jnp.linalg.eigh


def _rbf(n, n_test=24, seed=30):
    rng = np.random.default_rng(seed)
    x, y, xs = rng.normal(size=(n, 2)), rng.normal(size=(n,)), rng.normal(size=(n_test, 2))
    kernel = JaxScale.create(JaxRBF.create(ard_dims=2, dtype=jnp.float64), dtype=jnp.float64)
    return kernel, x, y, xs, 0.2


def _rademacher(key, n, num):
    return np.asarray(jax.random.rademacher(key, (n, num), dtype=jnp.float64))


def _normals(key, rank, n, num):
    """The (u1, u2) ``sample_precond_probes(key, …)`` draws."""
    k1, k2 = jax.random.split(key)
    return (np.asarray(jax.random.normal(k1, (rank, num), jnp.float64)),
            np.asarray(jax.random.normal(k2, (n, num), jnp.float64)))


def _aug(n, seed):
    rng = np.random.default_rng(seed)
    x = rng.uniform(-2.0, 2.0, size=(n, 2))
    return np.concatenate([x, 0.2 * rng.normal(size=(n, 2))], 1), rng.normal(size=(n,)), rng


@functools.cache
def cases() -> dict:
    """Each case: the JAX call's arguments (``jax``) and the ranks' numpy
    inputs (``port``)."""
    c = {}
    kernel, x, y, xs, s2 = _rbf(240)
    leaves = jax_leaves(kernel)
    for name, key, num, rank, iters in (("mll", 11, 32, 0, 300), ("mll_pre", 22, 16, 8, 300)):
        k = jax.random.PRNGKey(key)
        noise = _normals(k, rank, 240, num) if rank else _rademacher(k, 240, num)
        c[name] = {"jax": dict(kernel=kernel, x=x, y=y, key=k, s2=s2, kw=dict(num_probes=num, max_iters=iters,
                                                                                tol=1e-12, precond_rank=rank)),
                   "port": {"kernel": leaves, "x": x, "y": y, "s2": s2, "noise": noise,
                            "kw": dict(max_iters=iters, tol=1e-12, precond_rank=rank)}}
    for name, rank, iters in (("post", 0, 400), ("post_pre", 8, 120)):
        c[name] = {"jax": dict(kernel=kernel, x=x, y=y, xs=xs, s2=s2, kw=dict(max_iters=iters, tol=1e-13,
                                                                               precond_rank=rank)),
                   "port": {"kernel": leaves, "x": x, "y": y, "xs": xs, "s2": s2,
                            "kw": dict(max_iters=iters, tol=1e-13, precond_rank=rank)}}
    kernel, x, y, _, s2 = _rbf(160)
    for name, key, rank in (("grads", 12, 0), ("grads_pre", 23, 8)):
        k = jax.random.PRNGKey(key)
        noise = _normals(k, rank, 160, 16) if rank else _rademacher(k, 160, 16)
        c[name] = {"jax": dict(kernel=kernel, x=x, y=y, key=k, s2=s2, kw=dict(num_probes=16, max_iters=200,
                                                                                tol=1e-12, precond_rank=rank)),
                   "port": {"kernel": leaves, "x": x, "y": y, "s2": s2, "noise": noise,
                            "kw": dict(max_iters=200, tol=1e-12, precond_rank=rank)}}
    kernel, x, y, _, s2 = _rbf(160, seed=31)
    k = jax.random.PRNGKey(13)
    c["train"] = {"jax": dict(kernel=kernel, x=x, y=y, key=k, s2=s2, kw=dict(num_probes=8, max_iters=150,
                                                                               tol=1e-10)),
                  "port": {"kernel": leaves, "x": x, "y": y, "s2": s2, "noise": _rademacher(k, 160, 8),
                           "kw": dict(max_iters=150, tol=1e-10), "steps": 8}}

    rng = np.random.default_rng(33)
    x, y = rng.normal(size=(160, 2)), rng.normal(size=(160,))
    aug = np.concatenate([x, 0.3 * rng.normal(size=(160, 2))], axis=1)
    k = jax.random.PRNGKey(14)
    c["gibbs"] = {"jax": dict(aug=aug, y=y, key=k, s2=0.3, kw=dict(num_probes=16, max_iters=250, tol=1e-12)),
                  "port": {"aug": aug, "y": y, "s2": 0.3, "noise": _rademacher(k, 160, 16),
                           "kw": dict(max_iters=250, tol=1e-12)}}
    aug, y, _ = _aug(256, 5)
    k = jax.random.PRNGKey(5)
    c["builder"] = {"jax": dict(aug=aug, y=y, key=k, s2=0.3, kw=dict(num_probes=8, max_iters=64, tol=1e-7)),
                    "port": {"aug": aug, "y": y, "s2": 0.3, "noise": _rademacher(k, 256, 8),
                             "kw": dict(max_iters=64, tol=1e-7)}}

    aug, y, rng = _aug(128, 8)
    y = np.sin(aug[:, 0])
    k, pk = jax.random.PRNGKey(31), jax.random.PRNGKey(77)
    pkey = np.asarray(jax.random.permutation(pk, 128)[:32])
    kw = dict(max_iters=40, tol=1e-10, precond_rank=32, precond="nystrom")
    c["nystrom"] = {"jax": dict(aug=aug, y=y, key=k, s2=0.1, kw=dict(num_probes=4, precond_key=pk, **kw)),
                    "port": {"aug": aug, "y": y, "s2": 0.1, "noise": _normals(k, 32, 128, 4),
                             "kw": dict(precond_key=pkey, **kw)}}
    xt = np.concatenate([rng.normal(size=(16, 2)), np.zeros((16, 2))], axis=1)
    state_kw = dict(max_iters=60, tol=1e-10, precond_rank=32, precond="nystrom")
    c["state"] = {"jax": dict(aug=aug, y=y, s2=0.1, pk=pk, xt=xt, state_kw=state_kw),
                  "port": {"aug": aug, "y": y, "s2": 0.1, "pkey": pkey, "xt": xt, "state_kw": state_kw,
                           "query_kw": dict(max_iters=64, tol=1e-10)}}
    c["chunked"] = {"jax": dict(aug=aug, y=y, s2=0.1, key=k, pk=pk),
                    "port": {"aug": aug, "y": y, "s2": 0.1, "noise": _normals(k, 32, 128, 4), "pkey": pkey,
                             "args": (8, 4, 1e-10, 32, "nystrom", 1.0)}}
    return c


def _packed(kern, xa, xb):
    return kern(xa[:, :2], jnp.exp(xa[:, 2:]), xb[:, :2], jnp.exp(xb[:, 2:]))


def jax_ref_live(p: int, only=None) -> dict:
    """JAX's results on its P-device virtual mesh, computed now: every case,
    or those named in ``only``."""
    c = {k: v["jax"] for k, v in cases().items()}
    mesh = jax_make_mesh(p)
    a = jnp.asarray
    ref = {}

    def want(name):
        return only is None or name in only

    for name in ("mll", "mll_pre"):
        if want(name):
            d = c[name]
            ref[name] = {"val": float(jax.jit(lambda k, yy, ss: jax_sharded_cg_mll(k, a(d["x"]), yy, d["key"], ss, mesh,
                                                                                  **d["kw"]))(d["kernel"], a(d["y"]),
                                                                                               a(d["s2"])))}
    for name in ("grads", "grads_pre"):
        if want(name):
            d = c[name]
            v, (gk, gy, gs) = jax.jit(jax.value_and_grad(
                lambda k, yy, ss: jax_sharded_cg_mll(k, a(d["x"]), yy, d["key"], ss, mesh, **d["kw"]),
                argnums=(0, 1, 2)))(d["kernel"], a(d["y"]), a(d["s2"]))
            ref[name] = {"val": float(v), "grads": {**jax_leaves(gk), "y": np.asarray(gy), "s2": np.asarray(gs)}}
    for name in ("post", "post_pre"):
        if want(name):
            d = c[name]
            mean, cov = jax.jit(lambda k, yy: jax_sharded_cg_posterior(k, a(d["x"]), yy, a(d["xs"]), a(d["s2"]), mesh,
                                                                       **d["kw"]))(d["kernel"], a(d["y"]))
            ref[name] = {"mean": np.asarray(mean), "cov": np.asarray(cov)}
    gibbs = JaxGibbsKernel()
    for name in ("gibbs", "builder"):
        if want(name):
            d = c[name]
            v, g = jax.jit(jax.value_and_grad(
                lambda aa, yy, ss: jax_sharded_cg_mll(gibbs, aa, yy, d["key"], ss, mesh, cross_fn=_packed, **d["kw"]),
                argnums=(0, 1, 2)))(a(d["aug"]), a(d["y"]), a(d["s2"]))
            ref[name] = {"val": float(v), "grads": dict(zip(("aug", "y", "s2"), map(np.asarray, g)))}
    cross = jax_packed_cross(2)
    if want("nystrom"):
        d = c["nystrom"]
        with mock.patch.object(jnp.linalg, "eigh", canonical_eigh):
            v, g = jax.jit(jax.value_and_grad(
                lambda aa, yy, ss: jax_sharded_cg_mll(None, aa, yy, d["key"], ss, mesh, cross_fn=cross, **d["kw"]),
                argnums=(0, 1, 2)))(a(d["aug"]), a(d["y"]), a(d["s2"]))
        ref["nystrom"] = {"val": float(v), "grads": dict(zip(("aug", "y", "s2"), map(np.asarray, g)))}
    if want("state"):
        d = c["state"]
        st = jax_sharded_posterior_state(None, a(d["aug"]), a(d["y"]), a(d["s2"]), mesh, precond_key=d["pk"],
                                         cross_fn=cross, **d["state_kw"])
        mean, cov, info = jax_sharded_posterior_query(st, a(d["xt"]), mesh, cross_fn=cross, max_iters=64, tol=1e-10,
                                                      return_info=True)
        mean_only, _ = jax_sharded_posterior_query(st, a(d["xt"]), mesh, cross_fn=cross, mean_only=True)
        ref["state"] = {"alpha": np.asarray(st.alpha), "lpc_pp": np.asarray(st.lpc @ st.lpc.T),
                        "alpha_relres": float(st.alpha_relres), "mean": np.asarray(mean), "cov": np.asarray(cov),
                        "relres": np.asarray(info["relres"]), "mean_only": np.asarray(mean_only)}
    if want("chunked"):
        d = c["chunked"]
        with mock.patch.object(jnp.linalg, "eigh", canonical_eigh):
            mll = jax_make_sharded_chunked_mll(mesh, "data", 4, 8, 4, 1e-10, 32, "nystrom", 1.0, cross)
            v, rr, (_, xg, rg, s2g) = mll.value_and_grad(None, a(d["aug"]), a(d["y"]), a(d["s2"]), d["key"],
                                                         pkey=d["pk"])
        ref["chunked"] = {"val": float(v), "relres": np.asarray(rr),
                          "grads": {"aug": np.asarray(xg), "y": np.asarray(rg), "s2": np.asarray(s2g)}}
    return ref


def inputs_digest() -> str:
    """The digest of every input JAX's side and the ranks get, which a
    fixture keeps from its pinning (``pinned_refs.DIGEST``)."""
    leaves, treedef = jax.tree_util.tree_flatten(cases())
    return pinned_refs.digest([*leaves, str(treedef)])


@functools.cache
def pinned() -> dict:
    return pinned_refs.load_checked(JAX_REF, inputs_digest())


def jax_ref(p: int) -> dict:
    """JAX's results at P, pinned by tools/pin_jax_parallel.py (the live
    computation, ``jax_ref_live``, takes ~60 s on one idle CPU, several
    times that beside the suite's other workers)."""
    return pinned()[str(p)]


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
    _live_is_pinned(2, ("post_pre", "grads"))


def test_pinned_jax_reference_at_four_ranks_is_the_live_one():
    """As above, one cheap case at P = 4, so that a pinned world size
    other than 2 is held to live JAX too."""
    _live_is_pinned(4, ("post",))


@pytest.fixture(scope="module")
def port(tmp_path_factory):
    """The three groups start together and run while JAX computes."""
    inputs = {k: v["port"] for k, v in cases().items()}
    groups = {p: start("torch_dist_harness:sharded_cg_cases", p, args=(inputs,),
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


#: The builder's run against the materialised row block's: rounding-level
#: differences in the operator (K·v + σ²v against (K + σ²I)·v) grown over
#: 64 iterations on the Gibbs Gram (ROADMAP §3's drift: 6e-6 by 20 at
#: cond ≈ 300).  JAX's own check of its builder holds it to 2e-3 in f32.
BUILDER_TOL = 1e-5
TOL = {"mll": 1e-8, "grads": 1e-8, "post": 1e-7, "mll_pre": 1e-6, "grads_pre": 1e-6, "post_pre": 1e-7,
       "gibbs": 1e-8, "builder": 1e-7, "nystrom": 1e-7, "state": 1e-7, "chunked": 1e-7}


def _compare(got: dict, ref: dict, rtol: float, what: str):
    for k, r in ref.items():
        if isinstance(r, dict):
            _compare(got[k], r, rtol, f"{what}.{k}")
        elif k != "relres":
            close(got[k], r, rtol, f"{what}.{k}")


@pytest.mark.parametrize("p", WORLDS)
@pytest.mark.parametrize("case", list(TOL))
def test_matches_jax_on_its_mesh(case, p, port):
    ref = jax_ref(p)[case]
    outs = port(p)
    got = outs[0]["builder_default" if case == "builder" else case]
    for o in outs[1:]:
        _compare(o[case if case != "builder" else "builder_default"], got, 0.0, f"rank {o['rank']}")
    _compare(got, ref, TOL[case], case)
    if case in ("nystrom", "state", "chunked"):
        assert np.max(got["relres"]) < 1e-8
    if case == "state":
        assert not got["broke"] and not got["broke_mean_only"]


@pytest.mark.parametrize("p", [2, 4])
@pytest.mark.parametrize("case", [*TOL, "builder_k2", "train"])
def test_matches_one_rank(case, p, port):
    """P ranks give P = 1's values and gradients: a gradient counted P
    times, or the σ² ridge on another rank's rows, fails."""
    key = "builder_default" if case == "builder" else case
    _compare(port(p)[0][key], port(1)[0][key], 1e-9, case)


@pytest.mark.parametrize("p", WORLDS)
def test_local_matvec_builder_matches_default(p, port):
    """K2's plain version on each rank's rectangular (N/P, N) block walks the
    materialised row block's trajectory to rounding (the builder adds the
    ridge after the product), and JAX's builder-form run too."""
    got, default = port(p)[0]["builder_k2"], port(p)[0]["builder_default"]
    _compare(got, default, BUILDER_TOL, "builder_k2")
    _compare(got, jax_ref(p)["builder"], BUILDER_TOL, "builder_k2 vs JAX")


@pytest.mark.parametrize("p", WORLDS)
def test_sharded_mll_trains(p, port):
    """A few Adam steps on the sharded objective with fixed probes: finite,
    falling, the same at every P."""
    vals = port(p)[0]["train"]["vals"]
    assert np.all(np.isfinite(vals)) and vals[-1] < vals[0]


@pytest.mark.parametrize("p", WORLDS)
def test_sharded_cg_rejects_indivisible_n(p, port):
    got = port(p)[0]["indivisible"]
    assert got == "no error" if p == 1 else "is not divisible by the mesh size" in got


def test_posterior_against_cholesky():
    """The converged sharded posterior (JAX's, which the port matches above)
    against the dense Cholesky one, as tests/test_sharded_cg.py checks."""
    d = cases()["post"]["jax"]
    k = d["kernel"]
    x, y, xs = map(jnp.asarray, (d["x"], d["y"], d["xs"]))
    kxx = k(x) + d["s2"] * jnp.eye(x.shape[0], dtype=jnp.float64)
    sol = jnp.linalg.solve(kxx, jnp.concatenate([y[:, None], k(xs, x).T], axis=1))
    ref = jax_ref(4)["post"]
    close(ref["mean"], k(xs, x) @ sol[:, 0], 1e-6, "mean")
    close(ref["cov"], k(xs) - k(xs, x) @ sol[:, 1:], 1e-6, "cov")
