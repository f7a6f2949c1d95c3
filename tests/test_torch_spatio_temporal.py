"""The port's spatio-temporal models and experiments against the JAX package
on the CPU.

Inputs are drawn with numpy and fed to both sides; the JAX side runs in
float64 (conftest turns x64 on), loss, gradient and predictive in one
jitted call.  Tolerances: rtol 1e-10 for the losses, 1e-8 for their
gradients and the predictives (two Cholesky factors and a Nyström root
between them).  The data preparation of each experiment equals the JAX
experiment's bit for bit; each entry point runs on the CPU at a tiny
budget.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.stats
import torch

from nonstationary_precip_tpu.data.datasets import load_uib_spatio_temporal as jax_load_st
from nonstationary_precip_tpu.data.datasets import spatio_temporal_month_split as jax_month_split
from nonstationary_precip_tpu.models import SparseSpatioTemporalNonstationary as JaxSparseST
from nonstationary_precip_tpu.models import SpatioTemporalStationary as JaxStationaryST
from nonstationary_precip_tpu.priors import LogNormalProcess as JaxLogNormalProcess
from nonstationary_precip_tpu.train import metrics as jax_metrics

from nonstationary_precip_tpu_torch import interop
from nonstationary_precip_tpu_torch.data.datasets import spatio_temporal_month_split
from nonstationary_precip_tpu_torch.experiments import (
    sgpr_bench,
    spatio_temporal,
    spatiotemporal_dgp,
    spatiotemporal_stationary,
)
from nonstationary_precip_tpu_torch.train import metrics

torch.set_num_threads(1)

F64 = torch.float64
CPU = torch.device("cpu")


def jax_leaves(tree) -> dict:
    """A JAX pytree flattened to {dotted path: numpy array}, sequence keys as
    their index (the port's parameter names)."""
    out = {}
    for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]:
        out[jax.tree_util.keystr(path)[1:].replace("[", ".").replace("]", "").replace("..", ".")] = np.asarray(v)
    return out


def t64(a):
    return torch.tensor(np.asarray(a), dtype=F64)


@jax.jit
def _jax_loss_grad_pred(m, x, y, xs):
    loss, g = jax.value_and_grad(lambda mm: mm.loss(x, y))(m)
    pred = m.predictive(x, y, xs)
    return loss, g, pred.mean, pred.cov


def _perturbed(jm, rng, skip=("z",)):
    """The JAX model with every leaf but ``skip``'s moved by 0.1·N(0, 1)."""
    leaves = jax_leaves(jm)
    new = [jnp.asarray(v if k in skip else v + 0.1 * rng.normal(size=np.shape(v))) for k, v in leaves.items()]
    return jax.tree_util.tree_unflatten(jax.tree_util.tree_structure(jm), new)


def _st_inputs(rng, n):
    """(time, lon, lat) rows: 4 months of n/4 sites, standardised-looking."""
    sites = rng.normal(size=(n // 4, 2))
    x = np.concatenate([np.column_stack([np.full(n // 4, t), sites]) for t in (-1.2, -0.4, 0.4, 1.2)])
    y = np.sin(2 * x[:, 1]) + 0.5 * x[:, 0] + 0.1 * rng.normal(size=n)
    return x, y


def _check_pair(jm, tm, x, y, xs, train_all: bool):
    loss_j, g_j, mean_j, cov_j = _jax_loss_grad_pred(jm, *(jnp.asarray(a) for a in (x, y, xs)))
    if train_all:
        for p in tm.parameters():
            p.requires_grad_(True)
    loss = tm.loss(t64(x), t64(y))
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(loss_j), rtol=1e-10)
    ref = jax_leaves(g_j)
    grads = {n: p.grad for n, p in tm.named_parameters() if p.requires_grad}
    assert grads and set(grads) <= set(ref), sorted(set(grads) - set(ref))
    for name, g in grads.items():
        np.testing.assert_allclose(g.numpy(), ref[name], rtol=1e-8, atol=1e-11 * max(np.abs(ref[name]).max(), 1.0),
                                   err_msg=name)
    with torch.no_grad():
        pred = tm.predictive(t64(x), t64(y), t64(xs))
    np.testing.assert_allclose(pred.mean.numpy(), np.asarray(mean_j), rtol=1e-8, atol=1e-10)
    np.testing.assert_allclose(pred.cov.numpy(), np.asarray(cov_j), rtol=1e-8, atol=1e-10)
    return pred


def test_stationary_st_loss_gradients_and_predictive_match_jax():
    rng = np.random.default_rng(7)
    x, y = _st_inputs(rng, 40)
    xs = _st_inputs(rng, 12)[0]
    jm = _perturbed(JaxStationaryST.create(noise=0.1, dtype=jnp.float64), rng)
    tm = interop.spatio_temporal_from_jax(jax_leaves(jm), CPU, F64)
    assert tm.kernel.kernels[0].lower_bound == 7.0 and tm.mean_type == "zero"
    pred = _check_pair(jm, tm, x, y, xs, train_all=False)
    # the metric the experiments report
    yt = t64(np.sin(xs[:, 1]))
    np.testing.assert_allclose(float(metrics.nlpd_marginal(yt, pred.mean, pred.var)),
                               float(jax_metrics.nlpd_marginal(jnp.asarray(yt.numpy()), jnp.asarray(pred.mean.numpy()),
                                                               jnp.asarray(pred.var.numpy()))), rtol=1e-12)


@pytest.mark.parametrize("scale_correction", [False, True])
def test_sparse_nonstationary_st_loss_gradients_and_predictive_match_jax(scale_correction):
    """Every leaf's gradient (the frozen prior's and z's too), the loss and
    the predictive at 40 rows and 12 inducing inputs."""
    rng = np.random.default_rng(13)
    x, y = _st_inputs(rng, 40)
    xs = _st_inputs(rng, 12)[0]
    z = x[rng.permutation(40)[:12]] + 0.05 * rng.normal(size=(12, 3))
    prior = JaxLogNormalProcess.create(input_dim=2, mean=math.log(0.3), outputscale=1.0, lengthscale=1.3,
                                       dtype=jnp.float64)
    jm = JaxSparseST.create(jnp.asarray(z), prior, noise=0.1, dtype=jnp.float64)
    jm = _perturbed(jm, rng, skip=("z",) + tuple(k for k in jax_leaves(jm) if k.startswith("prior.")))
    jm = jm.replace(scale_correction=scale_correction)
    tm = interop.spatio_temporal_from_jax(jax_leaves(jm), CPU, F64, scale_correction=scale_correction)
    assert not tm.z.requires_grad and not any(p.requires_grad for p in tm.prior.parameters())
    _check_pair(jm, tm, x, y, xs, train_all=True)


def test_month_split_and_stationary_prep_match_jax():
    """The ST split (172 + 43 rows) and the exact baseline's first five
    months with Box-Cox y equal the JAX experiments', bit for bit."""
    ours, ref = spatio_temporal_month_split(), jax_month_split()
    for a, b in zip(ours, ref):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    df, x, y = jax_load_st()
    sites = df.groupby("time").size().iloc[0]
    x, y = x[: int(sites) * 5], y[: int(sites) * 5]
    x_norm = (x - x.mean(0)) / x.std(0, ddof=1)
    y_tr, lmbda = scipy.stats.boxcox(y)
    n_train = int(sites) * 4
    got = spatiotemporal_stationary.prepare()
    for a, b in zip(got, (x_norm[:n_train], y_tr[:n_train], x_norm[n_train:], y_tr[n_train:], lmbda)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    assert got[0].shape == (172, 3) and got[2].shape == (43, 3)


def test_sgpr_bench_prep_matches_jax():
    """The SGPR cut (4540 of 5676 rows) and z (1900 training rows) are the
    JAX experiment's own draws, bit for bit in float32."""
    cfg = sgpr_bench.default_config()
    _, x, y = jax_load_st()
    x_norm = (x - x.mean(0)) / x.std(0, ddof=1)
    rng = np.random.default_rng(173)
    idx = rng.permutation(len(y))
    tr, te = idx[:4540], idx[4540:]
    z_ref = x_norm[tr].astype(np.float32)[rng.permutation(4540)[:1900]]
    got = sgpr_bench.prepare(cfg)
    for a, b in zip(got, (x_norm[tr], y[tr], x_norm[te], y[te], z_ref)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b, dtype=np.float32))


ENTRY_POINTS = {
    "spatiotemporal_stationary": (spatiotemporal_stationary, ["--max_iters", "2"]),
    "spatio_temporal_stationary": (spatio_temporal, ["--model", "Stationary", "--max_iters", "2"]),
    "spatio_temporal_nonstationary": (spatio_temporal, ["--model", "Non-Stationary", "--max_iters", "2",
                                                        "--num_inducing", "20"]),
    "spatiotemporal_dgp": (spatiotemporal_dgp, ["--num_epochs", "2", "--num_inducing", "16"]),
    "sgpr_bench": (sgpr_bench, ["--max_iters", "2", "--num_inducing", "40"]),
}


@pytest.mark.parametrize("name", list(ENTRY_POINTS))
def test_entry_points_run_on_the_cpu_and_default_to_the_card(name, tmp_path, monkeypatch):
    """Each entry point runs at a tiny budget with ``--device cpu`` and
    writes only under ``NSGP_RESULTS_DIR``; without it, it asks for the card
    and raises where there is none."""
    module, argv = ENTRY_POINTS[name]
    monkeypatch.setenv("NSGP_RESULTS_DIR", str(tmp_path))
    rmse, nlpd = module.main(argv + ["--device", "cpu"])
    assert np.isfinite(rmse) and np.isfinite(nlpd)
    if module is spatio_temporal:
        model = argv[1].lower()
        field = np.loadtxt(tmp_path / f"st_{model}_means_sigmas.csv", delimiter=",", skiprows=1)
        assert field.shape == (215, 5) and np.isfinite(field).all()
        with open(tmp_path / f"st_{model}_means_sigmas.csv") as fh:
            assert fh.readline().strip() == "pred,std,time,lon,lat"
        assert (tmp_path / f"st_{model}_facets.png").stat().st_size > 0
    if module is spatiotemporal_dgp:
        assert np.load(tmp_path / "results_st_dgp_mean.npy").shape == (43,)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            module.main(argv)


def test_metrics_nlpd_marginal_is_the_per_point_density():
    mean = torch.tensor([0.0, 1.0])
    var = torch.tensor([1.0, 4.0])
    y = torch.tensor([0.5, -1.0])
    want = -np.mean([-0.5 * (0.25 + math.log(2 * math.pi)), -0.5 * (4.0 / 4.0 + math.log(2 * math.pi * 4.0))])
    np.testing.assert_allclose(float(metrics.nlpd_marginal(y, mean, var)), want, rtol=1e-6)
