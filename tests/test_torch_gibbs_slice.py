"""The PyTorch port's 10-split exact Gibbs MAP slice against the JAX package,
module by module and as a whole, in float64 on the CPU.

Inputs are drawn with numpy and fed to both sides.  JAX models are created
with an explicit dtype (conftest turns x64 on).  On the CPU the JAX
``gibbs_map_loss_batched`` takes its vmapped per-split loss, the same math
as the port's batched (L, L⁻¹) path, which here runs K1's plain version.
Tolerances: rtol 1e-10 where both sides do the same f64 arithmetic in
another order; 1e-9 where a posterior goes through two ill-conditioned
solves (the 1e-4-jittered prior Gram, cond ~ 1e5); 1e-8 for gradients and
for 25 optimiser steps, which amplify the rounding differences.
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from nonstationary_precip_tpu.data.dataprep import shuffle_split as jax_shuffle_split
from nonstationary_precip_tpu.data.datasets import load_uib_spatial as jax_load_uib_spatial
from nonstationary_precip_tpu.experiments import spatial_gibbs as jax_exp
from nonstationary_precip_tpu.models.gibbs_gp import GibbsExactGP as JaxGibbsExactGP
from nonstationary_precip_tpu.models.gibbs_gp import gibbs_map_loss_batched as jax_map_loss_batched
from nonstationary_precip_tpu.priors import LogNormalProcess as JaxLogNormalProcess
from nonstationary_precip_tpu.train import metrics as jax_metrics
from nonstationary_precip_tpu.train.config import ExperimentConfig as JaxConfig
from nonstationary_precip_tpu.train.vmapped import Stacked as JaxStacked
from nonstationary_precip_tpu.train.vmapped import fit_splits as jax_fit_splits
from nonstationary_precip_tpu.train.vmapped import stack_pytrees

from nonstationary_precip_tpu_torch import interop
from nonstationary_precip_tpu_torch.data.dataprep import shuffle_split
from nonstationary_precip_tpu_torch.data.datasets import load_uib_spatial
from nonstationary_precip_tpu_torch.experiments import spatial_gibbs
from nonstationary_precip_tpu_torch.models.gibbs_gp import gibbs_map_loss_batched
from nonstationary_precip_tpu_torch.priors.lognormal_process import LogNormalProcess
from nonstationary_precip_tpu_torch.train import metrics
from nonstationary_precip_tpu_torch.train.vmapped import Stacked, eval_splits, fit_splits, unstack_module
from nonstationary_precip_tpu_torch.utils.config import BASE_SEED, device

torch.set_num_threads(1)

F64 = torch.float64
CPU = torch.device("cpu")
REPO = Path(__file__).resolve().parent.parent


def jax_leaves(tree) -> dict:
    """A JAX pytree flattened to {dotted path: numpy array}, the form
    ``interop`` takes."""
    flat = jax.tree_util.tree_flatten_with_path(tree)[0]
    return {".".join(str(getattr(k, "name", k)) for k in path): np.asarray(leaf) for path, leaf in flat}


def t64(a):
    return torch.tensor(np.asarray(a), dtype=F64)


def _prior_pair():
    jp = JaxLogNormalProcess.create(input_dim=2, mean=np.log(0.3), outputscale=1.0, lengthscale=1.3,
                                    dtype=jnp.float64)
    tp = LogNormalProcess.create(input_dim=2, mean=np.log(0.3), outputscale=1.0, lengthscale=1.3,
                                 dtype=F64)
    return jp, tp


def _model_pair(rng, n, noise=0.011, scale=0.644):
    """A JAX GibbsExactGP with a perturbed latent field, and the port's
    model carried over from its leaves."""
    x = rng.normal(size=(n, 2))
    y = np.sin(2 * x[:, 0]) + 0.1 * rng.normal(size=n)
    jp, _ = _prior_pair()
    jm = JaxGibbsExactGP.create(jnp.asarray(x), jp, noise=noise, outputscale=scale, dtype=jnp.float64)
    jm = jm.replace(log_ell=jm.log_ell + 0.2 * jnp.asarray(rng.normal(size=(n, 2))))
    return jm, interop.gibbs_exact_from_jax(jax_leaves(jm), CPU, F64), x, y


def test_load_uib_spatial_and_shuffle_split_match_jax():
    _, x_j, y_j = jax_load_uib_spatial()
    cols, x, y = load_uib_spatial()
    assert cols == ("lon", "lat", "tp")
    assert np.array_equal(x, x_j) and np.array_equal(y, y_j)
    for s in range(10):
        ours = shuffle_split(x, y, 0.8, BASE_SEED + s)
        ref = jax_shuffle_split(x_j, y_j, 0.8, BASE_SEED + s)
        assert ours[0].shape == (316, 2)
        for a, b in zip(ours, ref):
            assert np.array_equal(a, b)


def test_prior_gram_pre_log_prob_conditional_mean_match_jax():
    rng = np.random.default_rng(173)
    n, m = 50, 12
    x, xs = rng.normal(size=(n, 2)), rng.normal(size=(m, 2))
    log_ell = np.log(0.3) + 0.3 * rng.normal(size=(n, 2))
    jp, tp = _prior_pair()
    kinv_j, logdet_j = jp.gram_pre(jnp.asarray(x))
    kinv, logdet = tp.gram_pre(t64(x))
    np.testing.assert_allclose(logdet.numpy(), np.asarray(logdet_j), rtol=1e-10)
    np.testing.assert_allclose(kinv.numpy(), np.asarray(kinv_j), rtol=1e-10, atol=1e-10 * np.abs(kinv_j).max())
    for pre_j, pre in (((kinv_j, logdet_j), (kinv, logdet)), (None, None)):
        lp_j = jp.log_prob(jnp.asarray(x), jnp.asarray(log_ell), pre_j)
        lp = tp.log_prob(t64(x), t64(log_ell), pre)
        np.testing.assert_allclose(float(lp), float(lp_j), rtol=1e-10)
    cm_j = jp.conditional_mean(jnp.asarray(xs), (jnp.asarray(x), jnp.exp(jnp.asarray(log_ell))))
    cm = tp.conditional_mean(t64(xs), (t64(x), torch.exp(t64(log_ell))))
    np.testing.assert_allclose(cm.numpy(), np.asarray(cm_j), rtol=1e-10)


def test_gibbs_kernel_matches_jax():
    """``GibbsKernel`` (with ``active_dims``) and ``gibbs_diag`` against the
    JAX kernel: the same Gram in f64, to rtol 1e-12."""
    from nonstationary_precip_tpu.kernels.gibbs import GibbsKernel as JaxGibbsKernel
    from nonstationary_precip_tpu_torch.kernels.gibbs import GibbsKernel, gibbs_diag

    rng = np.random.default_rng(5)
    x1, x2 = rng.normal(size=(9, 3)), rng.normal(size=(7, 3))
    e1, e2 = np.exp(0.3 * rng.normal(size=(9, 2))), np.exp(0.3 * rng.normal(size=(7, 2)))
    ref = JaxGibbsKernel(active_dims=(0, 2))(jnp.asarray(x1), jnp.asarray(e1), jnp.asarray(x2), jnp.asarray(e2))
    ours = GibbsKernel(active_dims=(0, 2))(t64(x1), t64(e1), t64(x2), t64(e2))
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=1e-12)
    np.testing.assert_allclose(GibbsKernel()(t64(x1[:, :2]), t64(e1)).diagonal().numpy(), 1.0, rtol=1e-14)
    np.testing.assert_array_equal(gibbs_diag(t64(x1), t64(e1)).numpy(), np.ones(9))
    with pytest.raises(ValueError, match="active dims"):
        GibbsKernel(active_dims=(0, 2))(t64(x1), t64(np.ones((9, 3))))


def test_gibbs_exact_loss_and_gradients_match_jax():
    """Value and gradients w.r.t. every leaf (the prior's too: it is frozen
    in training but its pullback must still be right) at n = 60."""
    rng = np.random.default_rng(173)
    jm, tm, x, y = _model_pair(rng, 60)
    pre_j = jm.prior.gram_pre(jnp.asarray(x))
    loss_j, g_j = jax.value_and_grad(lambda m: m.loss(jnp.asarray(x), jnp.asarray(y), pre_j))(jm)
    with torch.no_grad():  # hoisted outside the gradient, as pre_j is
        pre = tm.prior.gram_pre(t64(x))
    for p in tm.parameters():
        p.requires_grad_(True)
    loss = tm.loss(t64(x), t64(y), pre)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(loss_j), rtol=1e-10)
    # the hoisted gram_pre carries no gradient to the prior on either side;
    # the un-hoisted form pulls back through the prior's Cholesky
    loss_j2, g_j2 = jax.value_and_grad(lambda m: m.loss(jnp.asarray(x), jnp.asarray(y)))(jm)
    tm2 = interop.gibbs_exact_from_jax(jax_leaves(jm), CPU, F64)
    for p in tm2.parameters():
        p.requires_grad_(True)
    tm2.loss(t64(x), t64(y)).backward()
    for ref, model in ((g_j, tm), (g_j2, tm2)):
        grads = {n: p.grad for n, p in model.named_parameters()}
        for name, g in jax_leaves(ref).items():
            ours = grads[name]
            ours = torch.zeros_like(t64(g)) if ours is None else ours
            np.testing.assert_allclose(ours.numpy(), g, rtol=1e-8, atol=1e-12 * max(np.abs(g).max(), 1.0))


def test_gibbs_map_loss_batched_matches_jax():
    """The port's batched loss (through K1's plain version) against the JAX
    batched loss (its vmapped per-split form here) at T = 3, n = 140.

    The two pullbacks take different routes (K1's matmuls against L⁻¹
    against the JAX path's triangular solves), so near-zero gradient entries
    carry relative noise: gradients are held to rtol 1e-8 plus 1e-10 of the
    gradient's largest entry."""
    rng = np.random.default_rng(17)
    pairs = [_model_pair(rng, 140) for _ in range(3)]
    jms = stack_pytrees([p[0] for p in pairs])
    x, y = jnp.asarray(np.stack([p[2] for p in pairs])), jnp.asarray(np.stack([p[3] for p in pairs]))
    pre_j = jax.vmap(pairs[0][0].prior.gram_pre)(x)
    per_j = jax_map_loss_batched(jms, x, y, pre_j)
    g_ref = jax.grad(lambda m: jnp.sum(jax_map_loss_batched(m, x, y, pre_j)))(jms)

    tm = interop.gibbs_exact_from_jax(jax_leaves(jms), CPU, F64).trainable(train_noise=True, train_scale=True)
    with torch.no_grad():
        pre = tm.prior.gram_pre(t64(x))
    per = gibbs_map_loss_batched(tm, t64(x), t64(y), pre)
    per.sum().backward()
    np.testing.assert_allclose(per.detach().numpy(), np.asarray(per_j), rtol=1e-10)
    leaves = jax_leaves(g_ref)
    for name in ("log_ell", "raw_outputscale", "likelihood.raw_noise"):
        g = leaves[name]
        np.testing.assert_allclose(tm.get_parameter(name).grad.numpy(), g, rtol=1e-8,
                                   atol=1e-10 * np.abs(g).max())


def test_posterior_predictive_and_metrics_match_jax():
    rng = np.random.default_rng(29)
    jm, tm, x, y = _model_pair(rng, 50)
    xs = rng.normal(size=(15, 2))
    ys = np.sin(2 * xs[:, 0])
    with torch.no_grad():
        for noiseless in (True, False):
            pj = jm.posterior(jnp.asarray(x), jnp.asarray(y), jnp.asarray(xs), noiseless=noiseless)
            p = tm.posterior(t64(x), t64(y), t64(xs), noiseless=noiseless)
            np.testing.assert_allclose(p.mean.numpy(), np.asarray(pj.mean), rtol=1e-9)
            np.testing.assert_allclose(p.cov.numpy(), np.asarray(pj.cov), rtol=1e-9,
                                       atol=1e-12 * np.abs(pj.cov).max())
        pj = jm.predictive(jnp.asarray(x), jnp.asarray(y), jnp.asarray(xs))
        p = tm.predictive(t64(x), t64(y), t64(xs))
        noisy = tm.posterior(t64(x), t64(y), t64(xs)).add_noise(tm.likelihood.noise)
        np.testing.assert_allclose(noisy.cov.numpy(), p.cov.numpy(), rtol=1e-14)
        np.testing.assert_allclose(p.var.numpy(), np.asarray(pj.cov).diagonal(), rtol=1e-9)
        np.testing.assert_allclose(float(metrics.nlpd_joint(p, t64(ys), 2.5)),
                                   float(jax_metrics.nlpd_joint(pj, jnp.asarray(ys), 2.5)), rtol=1e-9)
        np.testing.assert_allclose(float(metrics.rmse_rescaled(p.mean, t64(ys), 2.5)),
                                   float(jax_metrics.rmse_rescaled(pj.mean, jnp.asarray(ys), 2.5)), rtol=1e-9)
        np.testing.assert_allclose(float(metrics.rmse_raw(p.mean, t64(ys))),
                                   float(jax_metrics.rmse_raw(pj.mean, jnp.asarray(ys))), rtol=1e-9)
        np.testing.assert_allclose(tm.lengthscale_field(t64(x), t64(xs)).numpy(),
                                   np.asarray(jm.lengthscale_field(jnp.asarray(x), jnp.asarray(xs))), rtol=1e-10)


def test_slice_fit_and_eval_splits_match_jax():
    """The slice as a whole: 2 real UIB splits (316 training points each),
    25 Adam steps in f64 with the prior, noise and outputscale frozen as
    ``make_split`` freezes them, then the batched evaluation.  Both sides
    start from the same weights (carried over by ``interop``)."""
    cfg = JaxConfig(lr=0.01, max_iters=25)
    _, x, y = jax_load_uib_spatial()
    x_norm = (x - x.mean(0)) / x.std(0, ddof=1)
    stdy = y.std(ddof=1)
    y_norm = (y - y.mean()) / stdy
    splits = [jax_exp.make_split(x_norm, y_norm, s, cfg, jnp.float64) for s in range(2)]
    models = [s[0] for s in splits]
    xs = jnp.stack([s[2][0] for s in splits])
    ys = jnp.stack([s[2][1] for s in splits])
    pre_j = jax.vmap(jax_exp.build_prior(cfg, jnp.float64).gram_pre)(xs)
    res_j = jax_fit_splits(models, lambda m, a, b, c: m.loss(a, b, c), list(xs), list(ys), JaxStacked(pre_j),
                           lr=cfg.lr, num_steps=cfg.max_iters, masks=[s[1] for s in splits],
                           batched_loss=jax_map_loss_batched)

    tms = [interop.gibbs_exact_from_jax(jax_leaves(m), CPU, F64) for m in models]
    x_tr = [t64(s[3][0]) for s in splits]
    y_tr = [t64(s[3][1]) for s in splits]
    pre = LogNormalProcess.create(input_dim=2, mean=np.log(cfg.prior_mean), outputscale=cfg.prior_scale,
                                  lengthscale=cfg.prior_ell, dtype=F64).gram_pre(torch.stack(x_tr))
    res = fit_splits(tms, lambda m, a, b, c: m.loss(a, b, c), x_tr, y_tr, Stacked(pre),
                     lr=cfg.lr, num_steps=cfg.max_iters, batched_loss=gibbs_map_loss_batched)
    assert res.losses.shape == (25, 2) and res.steps == 25
    np.testing.assert_allclose(res.losses, np.asarray(res_j.losses), rtol=1e-8)
    np.testing.assert_allclose(res.model.log_ell.detach().numpy(), np.asarray(res_j.model.log_ell), rtol=1e-8,
                               atol=1e-10)
    # the frozen leaves did not move
    np.testing.assert_array_equal(res.model.raw_outputscale.detach().numpy(),
                                  np.stack([np.asarray(m.raw_outputscale) for m in models]))

    def eval_j(m, xtr, ytr, xte, yte):
        pred = m.predictive(xtr, ytr, xte)
        return jax_metrics.rmse_rescaled(pred.mean, yte, stdy), jax_metrics.nlpd_joint(pred, yte, stdy)

    from nonstationary_precip_tpu.train.vmapped import eval_splits as jax_eval_splits

    rm_j, nl_j = jax_eval_splits(res_j.model, eval_j, *tuple(zip(*[s[3] for s in splits])))
    rm, nl = eval_splits(res.model, spatial_gibbs._eval_one(stdy), x_tr, y_tr,
                         [t64(s[3][2]) for s in splits], [t64(s[3][3]) for s in splits])
    np.testing.assert_allclose(rm.numpy(), np.asarray(rm_j), rtol=1e-8)
    np.testing.assert_allclose(nl.numpy(), np.asarray(nl_j), rtol=1e-8)
    # unstacking gives back per-split modules
    one = unstack_module(res.model, 2)[1]
    np.testing.assert_array_equal(one.log_ell.detach().numpy(), res.model.log_ell.detach()[1].numpy())


def test_fit_threshold_stop_and_nan_guard_match_jax():
    """``fit``'s Adam, |Δloss| stop and NaN guard against the JAX ``fit`` on
    a quadratic in f64: the same steps run and the same loss trace (rtol
    1e-10: the same Adam arithmetic in another order)."""
    from nonstationary_precip_tpu.train.optim import fit as jax_fit
    from nonstationary_precip_tpu_torch.train.optim import fit

    target = np.array([1.0, -2.0])

    class Quad(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.w = torch.nn.Parameter(torch.tensor([3.0, 0.5], dtype=F64))

    res_j = jax_fit({"w": jnp.asarray([3.0, 0.5])}, lambda m: jnp.sum((m["w"] - target) ** 2),
                    lr=0.1, num_steps=1000, threshold=1e-4, chunk=25)
    res = fit(Quad(), lambda m: torch.sum((m.w - t64(target)) ** 2), lr=0.1, num_steps=1000, threshold=1e-4,
              chunk=25)
    assert res.steps == res_j.steps < 1000 and res.steps % 25 == 0
    np.testing.assert_allclose(res.losses, np.asarray(res_j.losses), rtol=1e-10)
    np.testing.assert_allclose(res.model.w.detach().numpy(), np.asarray(res_j.model["w"]), rtol=1e-10)

    calls = []

    def poisoned(m):  # turns non-finite from the 15th call on
        calls.append(1)
        loss = torch.sum((m.w - t64(target)) ** 2)
        return loss * float("nan") if len(calls) >= 15 else loss

    res = fit(Quad(), poisoned, lr=0.1, num_steps=100, chunk=10)
    assert res.steps == 20 and res.losses.shape == (20,)
    assert np.isfinite(res.losses[:14]).all() and not np.isfinite(res.losses[14:]).any()


def test_spatial_gibbs_main_writes_only_to_results_dir(tmp_path, monkeypatch):
    results = REPO / "results"
    before = sorted((p.name, p.stat().st_mtime_ns) for p in results.iterdir())
    monkeypatch.setenv("NSGP_RESULTS_DIR", str(tmp_path))
    rmse, nlpd = spatial_gibbs.main(["--max_iters", "5", "--num_splits", "2", "--device", "cpu"])
    assert np.isfinite(rmse) and np.isfinite(nlpd)
    field = np.loadtxt(tmp_path / spatial_gibbs.FIELD_CSV, delimiter=",", skiprows=1)
    assert field.shape == (394, 6) and np.isfinite(field).all()
    with open(tmp_path / spatial_gibbs.FIELD_CSV) as fh:
        assert fh.readline().strip() == "pred,std,lon,lat,ell0,ell1"
    assert sorted((p.name, p.stat().st_mtime_ns) for p in results.iterdir()) == before


def test_spatial_gibbs_refuses_what_is_not_ported():
    """Both of the JAX experiment's inference modes are ported; any other
    is refused before a model is built."""
    with pytest.raises(ValueError, match="exact or sparse"):
        spatial_gibbs.main(["--inference", "variational", "--max_iters", "1", "--num_splits", "1", "--device", "cpu"])


def test_device_helper_raises_without_cuda():
    assert device("cpu") == CPU
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            device("cuda")


def test_port_imports_without_jax_pandas_matplotlib():
    code = (
        "import sys\n"
        "for m in ('jax', 'pandas', 'matplotlib', 'nonstationary_precip_tpu'):\n"
        "    sys.modules[m] = None\n"
        "import nonstationary_precip_tpu_torch.experiments.spatial_gibbs\n"
        "import nonstationary_precip_tpu_torch.interop\n"
        "import nonstationary_precip_tpu_torch.ops.chol_inv\n"
        "assert not any(k == 'jax' or k.startswith('jax.') for k, v in sys.modules.items() if v is not None)\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stderr
