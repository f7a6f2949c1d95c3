"""The port's stationary exact GP against the JAX package, float64 on the
CPU: the kernels (``kernels/base.py``, ``kernels/stationary.py``), ``ExactGP``
with the Cholesky and the matrix-free solvers, ``lazy_cg_posterior``,
``interop.exact_gp_from_jax``, the ``seard_spatial`` and ``temporal``
experiments, and the pinned JAX fixture that ``chip_smoke.py`` reads.

Tolerances: the kernels agree to 1e-10 and the Cholesky MLL, its gradients
and the posterior to 1e-8 (relative to each array's largest entry): the
same f64 formulas in another framework.  The matrix-free MLL runs 8 mBCG
iterations, where two correct CG implementations have not drifted apart
(ROADMAP §3), and agrees to 1e-8 as well.
"""

import functools
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nonstationary_precip_tpu import kernels as jk
from nonstationary_precip_tpu.data.dataprep import load_csv as jload_csv
from nonstationary_precip_tpu.experiments import seard_spatial as jseard
from nonstationary_precip_tpu.models import ExactGP as JExactGP
from nonstationary_precip_tpu.ops import lazy_cg as jlazy
from nonstationary_precip_tpu.train.config import ExperimentConfig as JConfig
from nonstationary_precip_tpu.train.vmapped import fit_splits as jfit_splits
from nonstationary_precip_tpu_torch import interop
from nonstationary_precip_tpu_torch.data.dataprep import load_csv
from nonstationary_precip_tpu_torch.data.datasets import load_khyber_time_series
from nonstationary_precip_tpu_torch.experiments import seard_spatial, temporal
from nonstationary_precip_tpu_torch.kernels.base import Kernel, Scale
from nonstationary_precip_tpu_torch.kernels.stationary import RBF, Periodic
from nonstationary_precip_tpu_torch.ops import lazy_cg
from nonstationary_precip_tpu_torch.ops.matvec import stationary_matvec_builder
from nonstationary_precip_tpu_torch.train.vmapped import fit_splits
from nonstationary_precip_tpu_torch.utils.config import DATASET_DIR

torch.set_num_threads(1)
REPO = Path(__file__).resolve().parent.parent
F64 = torch.float64
N_LAZY, BLOCK, ITERS, RANK, PROBES = 256, 128, 8, 20, 8


def leaves(model) -> dict:
    """A JAX pytree's leaves by dotted path: the port's parameter names."""
    return {jax.tree_util.keystr(p)[1:].replace("[", ".").replace("]", ""): np.asarray(v)
            for p, v in jax.tree_util.tree_flatten_with_path(model)[0]}


def f64(tree):
    """A JAX pytree with float64 leaves (the kernels' ``create`` makes
    float32 raw leaves; both sides then compute from the same raw values)."""
    return jax.tree.map(lambda v: jnp.asarray(v, jnp.float64), tree)


def load(module: torch.nn.Module, values: dict) -> torch.nn.Module:
    """Set every parameter of a port module from ``values`` (f64)."""
    for name, p in module.named_parameters():
        p.data = torch.tensor(values[name], dtype=F64)
    return module


def _close(got, ref, rtol):
    got, ref = np.asarray(got, dtype=np.float64), np.asarray(ref, dtype=np.float64)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    np.testing.assert_allclose(got, ref, rtol=0, atol=rtol * max(np.abs(ref).max(), 1e-300))


# -- the kernels ------------------------------------------------------------------

KERNELS = {
    # name: (JAX kernel, the port's kernel of the same structure), D = 3
    "rbf": lambda: (jk.RBF.create(3, lengthscale=jnp.array([0.7, 1.3, 2.1])), RBF.create(3, dtype=F64)),
    "rbf_active_dims": lambda: (jk.RBF.create(2, lengthscale=jnp.array([0.6, 1.4]), active_dims=(0, 2)),
                                RBF.create(2, active_dims=(0, 2), dtype=F64)),
    "periodic": lambda: (jk.Periodic.create(3, lengthscale=jnp.array([0.8, 1.1, 1.5]), period=jnp.array([1.3, 2., .9])),
                         Periodic.create(3, dtype=F64)),
    "scale": lambda: (jk.Scale.create(jk.RBF.create(3, lengthscale=0.9), outputscale=1.7),
                      Scale.create(RBF.create(3, dtype=F64), dtype=F64)),
    "scale_lower_bound": lambda: (
        jk.Scale.create(jk.RBF.create(3) * jk.Periodic.create(3, period=1.4), outputscale=7.6931, lower_bound=7.0),
        Scale.create(RBF.create(3, dtype=F64) * Periodic.create(3, dtype=F64), lower_bound=7.0, dtype=F64)),
    "sum_active_dims": lambda: (
        jk.RBF.create(1, lengthscale=0.5, active_dims=(0,)) + jk.Periodic.create(2, period=1.7, active_dims=(1, 2)),
        RBF.create(1, active_dims=(0,), dtype=F64) + Periodic.create(2, active_dims=(1, 2), dtype=F64)),
    "product": lambda: (jk.RBF.create(3, lengthscale=1.2) * jk.Periodic.create(3, lengthscale=0.7),
                        RBF.create(3, dtype=F64) * Periodic.create(3, dtype=F64)),
}


@pytest.mark.parametrize("name", sorted(KERNELS))
def test_kernels_match_jax(name):
    """k(x1, x2), k(x1) and k.diag(x1), and the gradient of Σ W⊙k(x1, x2)
    in every raw parameter, to 1e-10."""
    jkern, kern = KERNELS[name]()
    jkern = f64(jkern)
    load(kern, leaves(jkern))
    rng = np.random.default_rng(5)
    x1, x2, w = rng.normal(size=(17, 3)), rng.normal(size=(11, 3)), rng.normal(size=(17, 11))
    t1, t2 = torch.tensor(x1), torch.tensor(x2)
    _close(kern(t1, t2).detach(), jkern(jnp.asarray(x1), jnp.asarray(x2)), 1e-10)
    _close(kern(t1).detach(), jkern(jnp.asarray(x1)), 1e-10)
    _close(kern.diag(t1).detach(), jkern.diag(jnp.asarray(x1)), 1e-10)
    jg = leaves(jax.grad(lambda k: jnp.sum(jnp.asarray(w) * k(jnp.asarray(x1), jnp.asarray(x2))))(jkern))
    torch.sum(torch.tensor(w) * kern(t1, t2)).backward()
    for pname, p in kern.named_parameters():
        _close(p.grad, jg[pname], 1e-10)


def test_scale_lower_bound_and_init():
    """Scale's bound (softplus(raw) + 7 at init 7.6931), RBF's raw-0 init
    (softplus(0) ≈ 0.6931) and the algebra's types."""
    k = temporal.make_temporal_kernel(F64)
    assert abs(k.outputscale.item() - 7.6931) < 1e-12
    jkern = jk.Scale.create(jk.RBF.create(1) * jk.Periodic.create(1), outputscale=7.6931, lower_bound=7.0)
    assert k.outputscale.item() == pytest.approx(float(jkern.outputscale), rel=1e-6)
    for name, v in leaves(jkern.base).items():
        np.testing.assert_array_equal(k.base.get_parameter(name).detach().numpy(), v)
    assert RBF.create(2).lengthscale[0].item() == pytest.approx(np.log(2.0), abs=1e-7)
    assert isinstance(RBF.create(1) + RBF.create(1), Kernel)


# -- ExactGP, Cholesky solver -----------------------------------------------------------


def _exact_pair(kind: str):
    """(JAX ExactGP, the port's, x, y, x_test) in f64: the seard model on
    2-D inputs, or the temporal model on 1-D inputs."""
    rng = np.random.default_rng(11)
    if kind == "seard":
        jm = JExactGP.create(jk.Scale.create(jk.RBF.create(2, lengthscale=jnp.array([0.8, 1.3])), outputscale=1.4),
                             noise=0.2, mean_type="constant", dtype=jnp.float64)
        kern, d = Scale.create(RBF.create(2, dtype=F64), dtype=F64), 2
    else:
        jm = JExactGP.create(jk.Scale.create(jk.RBF.create(1) * jk.Periodic.create(1, period=0.6),
                                             outputscale=7.6931, lower_bound=7.0),
                             noise=0.3, mean_type="constant", dtype=jnp.float64)
        kern, d = temporal.make_temporal_kernel(F64), 1
    jm = f64(jax.tree.map(lambda v: v + 0.05, jm))  # off the init, mean_const too
    x, xs = rng.uniform(-2, 2, size=(60, d)), rng.uniform(-2, 2, size=(9, d))
    y = np.sin(2 * x[:, 0]) + 0.1 * rng.normal(size=60)
    return jm, interop.exact_gp_from_jax(leaves(jm), kern, "cpu", F64), x, y, xs


@pytest.mark.parametrize("kind", ["seard", "temporal"])
def test_exact_gp_chol_mll_and_gradients_match_jax(kind):
    jm, m, x, y, _ = _exact_pair(kind)
    jv, jg = jax.value_and_grad(lambda mm: mm.mll(jnp.asarray(x), jnp.asarray(y)))(jm)
    val = m.mll(torch.tensor(x), torch.tensor(y))
    val.backward()
    _close(val.detach(), jv, 1e-8)
    jg = leaves(jg)
    for name, p in m.named_parameters():
        _close(p.grad, jg[name], 1e-8)


@pytest.mark.parametrize("kind", ["seard", "temporal"])
def test_exact_gp_chol_posterior_and_predictive_match_jax(kind):
    jm, m, x, y, xs = _exact_pair(kind)
    args = (jnp.asarray(x), jnp.asarray(y), jnp.asarray(xs))
    with torch.no_grad():
        post = m.posterior(torch.tensor(x), torch.tensor(y), torch.tensor(xs))
        pred = m.predictive(torch.tensor(x), torch.tensor(y), torch.tensor(xs))
    for got, ref in ((post, jm.posterior(*args)), (pred, jm.predictive(*args))):
        _close(got.mean, ref.mean, 1e-8)
        _close(got.cov, ref.cov, 1e-8)


def test_exact_gp_refuses_what_is_not_ported():
    _, m, x, y, _ = _exact_pair("seard")
    with pytest.raises(NotImplementedError, match="not yet ported"):
        m.mll(torch.tensor(x), torch.tensor(y), solver="cg")
    with pytest.raises(ValueError, match="requires solver='cg'"):
        m.mll(torch.tensor(x), torch.tensor(y), block=30)
    with pytest.raises(ValueError, match="probe_noise"):
        m.mll(torch.tensor(x), torch.tensor(y), solver="cg", block=30)


# -- ExactGP, matrix-free solver --------------------------------------------------------


@functools.lru_cache(maxsize=2)
def _lazy_case():
    """The JAX side of the matrix-free MLL at N = 256: value and gradients
    through ``_mll_machinery``'s core on the probes the port makes from the
    same normal draws, with JAX's own preconditioner factor."""
    rng = np.random.default_rng(13)
    x = rng.uniform(-2, 2, size=(N_LAZY, 2))
    y = np.sin(2 * x[:, 0]) * np.cos(x[:, 1]) + 0.1 * rng.normal(size=N_LAZY)
    jm = JExactGP.create(jk.Scale.create(jk.RBF.create(2, lengthscale=jnp.array([0.7, 1.1])), outputscale=1.3),
                         noise=0.1, mean_type="constant", dtype=jnp.float64)
    jm = f64(jax.tree.map(lambda v: v + 0.03, jm))
    u1, u2 = rng.normal(size=(RANK, PROBES)), rng.normal(size=(N_LAZY, PROBES))
    lpc = jlazy.lazy_pivoted_cholesky(jm.kernel, jnp.asarray(x), RANK)
    probes = lpc @ jnp.asarray(u1) + jnp.sqrt(jm.likelihood.noise) * jnp.asarray(u2)
    core = jlazy._mll_machinery(BLOCK, PROBES, ITERS, 1e-6, RANK, jlazy.default_cross, None, None, 1.0)

    def mll(mm):
        xx = jnp.asarray(x)
        return core(mm.kernel, xx, jnp.asarray(y) - mm.mean(xx), probes, mm.likelihood.noise, lpc) / N_LAZY

    jv, jg = jax.value_and_grad(mll)(jm)
    return jm, x, y, (u1, u2), float(jv), leaves(jg)


def _port_lazy_mll(builder):
    jm, x, y, (u1, u2), _, _ = _lazy_case()
    m = interop.exact_gp_from_jax(leaves(jm), Scale.create(RBF.create(2, dtype=F64), dtype=F64), "cpu", F64)
    val = m.mll(torch.tensor(x), torch.tensor(y), solver="cg", probe_noise=(torch.tensor(u1), torch.tensor(u2)),
                block=BLOCK, max_iters=ITERS, precond_rank=RANK, matvec_builder=builder)
    val.backward()
    return m, val.detach()


@pytest.mark.parametrize("builder", [None, stationary_matvec_builder], ids=["panels", "stationary_builder"])
def test_matrix_free_mll_value_and_all_gradients_match_jax(builder):
    """Value and the gradients of raw lengthscale, raw outputscale, raw
    noise and the mean, through the panel matvec and through the fused
    builder (K6's plain version here); the backward is the panel pullback
    through the kernel module either way."""
    *_, jv, jg = _lazy_case()
    m, val = _port_lazy_mll(builder)
    _close(val, jv, 1e-8)
    names = [n for n, _ in m.named_parameters()]
    assert sorted(names) == sorted(jg)
    for name, p in m.named_parameters():
        _close(p.grad, jg[name], 1e-8)


def test_lazy_cg_mll_module_kernel_gradients_regression():
    """The fault in the port that this test pins: ``lazy_cg_mll`` returned a
    kernel gradient only for a tensor kernel, so a module kernel's
    lengthscales and outputscale got none (None, no error) and matrix-free
    training froze them.  Now every kernel parameter gets JAX's gradient."""
    *_, jg = _lazy_case()
    m, _ = _port_lazy_mll(None)
    for name in ("kernel.base.raw_lengthscale", "kernel.raw_outputscale"):
        grad = m.get_parameter(name).grad
        assert grad is not None and bool(torch.all(grad != 0)), name
        _close(grad, jg[name], 1e-8)


@pytest.mark.parametrize("rank", [0, RANK])
def test_matrix_free_posterior_matches_jax(rank):
    """``lazy_cg_posterior`` and ``ExactGP.posterior(solver='cg')`` against
    JAX's ``lazy_cg_posterior`` (mean and cov, 8 mBCG iterations, with and
    without the preconditioner), and the breakdown poisoning."""
    jm, x, y, *_ = _lazy_case()
    xs = np.random.default_rng(17).uniform(-2, 2, size=(7, 2))
    m = interop.exact_gp_from_jax(leaves(jm), Scale.create(RBF.create(2, dtype=F64), dtype=F64), "cpu", F64)
    kw = dict(block=BLOCK, max_iters=ITERS, tol=1e-6, precond_rank=rank)
    resid = jnp.asarray(y) - jm.mean(jnp.asarray(x))
    jmean, jcov = jlazy.lazy_cg_posterior(jm.kernel, jnp.asarray(x), resid, jnp.asarray(xs), jm.likelihood.noise, **kw)
    with torch.no_grad():
        tx, ty, txs = torch.tensor(x), torch.tensor(y), torch.tensor(xs)
        mean, cov = lazy_cg.lazy_cg_posterior(m.kernel, tx, ty - m.mean(tx), txs, m.likelihood.noise, **kw)
        post = m.posterior(tx, ty, txs, solver="cg", matvec_builder=stationary_matvec_builder, **kw)
    _close(mean, jmean, 1e-8)
    _close(cov, jcov, 1e-8)
    jpost = jm.posterior(jnp.asarray(x), jnp.asarray(y), jnp.asarray(xs), solver="cg", **kw)
    _close(post.mean, jpost.mean, 1e-8)
    _close(post.cov, jpost.cov, 1e-8)
    with torch.no_grad():  # an indefinite operator breaks mBCG down: NaN, not a plausible answer
        bad_mean, bad_cov = lazy_cg.lazy_cg_posterior(m.kernel, tx, ty, txs, -5.0, block=BLOCK, max_iters=ITERS)
    assert bool(torch.isnan(bad_mean).all() and torch.isnan(bad_cov).all())


# -- interop, experiments, fixture --------------------------------------------------------


def test_exact_gp_from_jax_single_and_stacked():
    jm, m, x, y, _ = _exact_pair("temporal")
    _close(m.mll(torch.tensor(x), torch.tensor(y)).detach(), jm.mll(jnp.asarray(x), jnp.asarray(y)), 1e-10)
    stacked = {k: np.stack([v, v + 0.1]) for k, v in leaves(jm).items()}
    ms = interop.exact_gp_from_jax(stacked, temporal.make_temporal_kernel(F64), "cpu", F64)
    tx, ty = torch.tensor(np.stack([x, x])), torch.tensor(np.stack([y, y]))
    jm2 = jax.tree.map(lambda v: v + 0.1, jm)
    _close(ms.mll(tx, ty).detach(), [jm.mll(jnp.asarray(x), jnp.asarray(y)), jm2.mll(jnp.asarray(x), jnp.asarray(y))],
           1e-10)
    with pytest.raises(KeyError, match="missing"):
        interop.exact_gp_from_jax({"mean_const": 0.0}, Scale.create(RBF.create(1)), "cpu")


def test_seard_lockstep_fit_matches_jax_and_sequential_port():
    """2 splits × 10 Adam steps: the port's lockstep fit against the JAX
    ``fit_splits`` on the same splits (f64, rtol 1e-8), and, in float32 as
    the experiment runs, split 0 of the lockstep fit against the port's
    sequential fit (rtol 1e-6: the batched and the single factorisations
    round alike up to f32 summation order)."""
    jcfg = JConfig(model="whitening", lr=0.01, max_iters=10)
    cfg = seard_spatial.default_config().parse_args(["--max_iters", "10", "--device", "cpu"])
    jdata, data = jload_csv(DATASET_DIR / "uib_spatial.csv"), load_csv(DATASET_DIR / "uib_spatial.csv")
    jsplits = [jseard.make_split(jdata, rs, jcfg, jnp.float64) for rs in (0, 1)]
    jres = jfit_splits([s[0] for s in jsplits], lambda m, xx, yy: m.loss(xx, yy),
                       *tuple(zip(*[s[1] for s in jsplits])), lr=0.01, num_steps=10)
    splits = [seard_spatial.make_split(data, rs, cfg, F64) for rs in (0, 1)]
    for (_, (xt, _), _), (_, (jx, _), _) in zip(splits, jsplits):
        np.testing.assert_array_equal(xt.numpy(), np.asarray(jx))
    res = fit_splits([s[0] for s in splits], seard_spatial._loss, [s[1][0] for s in splits],
                     [s[1][1] for s in splits], lr=0.01, num_steps=10)
    np.testing.assert_allclose(res.losses, np.asarray(jres.losses), rtol=1e-8)
    r0, n0, seq = seard_spatial.run_one_split(data, 0, cfg)
    splits32 = [seard_spatial.make_split(data, rs, cfg) for rs in (0, 1)]
    res32 = fit_splits([s[0] for s in splits32], seard_spatial._loss, [s[1][0] for s in splits32],
                       [s[1][1] for s in splits32], lr=0.01, num_steps=10)
    np.testing.assert_allclose(seq.losses, res32.losses[:, 0], rtol=1e-6)
    assert np.isfinite(r0) and np.isfinite(n0)


def test_seard_run_smoke():
    out = seard_spatial.run(seard_spatial.default_config().parse_args(
        ["--max_iters", "3", "--num_splits", "2", "--device", "cpu"]))
    assert out["losses"].shape == (3, 2) and np.isfinite(out["losses"]).all()
    assert out["rmses"].shape == (2,) and np.isfinite([out["rmse"], out["nlpd"]]).all()


def test_temporal_main_smoke():
    """A few steps of the temporal experiment on the CPU, through ``main``
    and ``run``: the data (the JAX loader's, bit for bit), the 80/20 cut
    and finite metrics."""
    import pandas as pd

    t, tp = load_khyber_time_series()
    arr = np.asarray(pd.read_csv(DATASET_DIR / "khyber_time_series.csv", dtype=np.float64))
    np.testing.assert_array_equal(np.stack([t, tp], 1), arr)
    assert np.isfinite(temporal.main(["--max_iters", "3", "--device", "cpu"])).all()
    out = temporal.run(temporal.default_config().parse_args(["--max_iters", "5", "--device", "cpu"]))
    assert out["losses"].shape == (5,) and np.isfinite(out["losses"]).all()
    assert out["pred_mean"].shape == (342 - 273,)
    assert all(np.isfinite(out[k]) for k in ("rmse", "nlpd", "raw_rmse"))
    assert out["model"].kernel.outputscale.item() > 7.0


def test_pinned_fixture_shapes():
    ref = np.load(REPO / "tests" / "fixtures" / "jax_exact_ref.npz")
    assert ref["seard_losses"].shape == (51, 2) and ref["seard_checksums"].shape == (2, 3)
    n, rank = int(ref["lazy_n"]), int(ref["lazy_rank"])
    assert ref["lazy_x"].shape == (n, 2) and ref["lazy_y"].shape == (n,)
    assert ref["lazy_u1"].shape == (rank, 8) and ref["lazy_u2"].shape == (n, 8)
    assert ref["lazy_losses"].shape == (int(ref["lazy_steps"]),)
    assert ref["lazy_x"].dtype == np.float32 and np.isfinite(ref["lazy_losses"]).all()
    assert (REPO / "tests" / "fixtures" / "jax_exact_ref.npz").stat().st_size < 1 << 20


def test_new_modules_import_without_jax():
    code = (
        "import sys\n"
        "for m in ('jax', 'pandas', 'matplotlib', 'nonstationary_precip_tpu'):\n"
        "    sys.modules[m] = None\n"
        "import nonstationary_precip_tpu_torch.experiments.seard_spatial\n"
        "import nonstationary_precip_tpu_torch.experiments.temporal\n"
        "import nonstationary_precip_tpu_torch.experiments.exact_largen\n"
        "import nonstationary_precip_tpu_torch.ops.chol_stream\n"
        "import nonstationary_precip_tpu_torch.models.exact_gp\n"
        "assert not any(k == 'jax' or k.startswith('jax.') for k, v in sys.modules.items() if v is not None)\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stderr
