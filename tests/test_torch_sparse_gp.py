"""The port's sparse GPs (k-means, the Nyström root, SGPR and GibbsSparseGP)
against the JAX package on the CPU.

Inputs are drawn with numpy and fed to both sides; the JAX side runs in
float64 (conftest turns x64 on) and jitted where it loops.  Tolerances:
rtol 1e-10 where both sides do the same float64 arithmetic in another order
(k-means, the root); 1e-8 for the losses, their gradients and the
predictives, which pass through two Cholesky factors and the Woodbury
identity.  The pinned float32 JAX runs (``tests/fixtures/jax_sparse_ref.npz``,
``tools/pin_jax_sparse.py``) hold the port's step-0 losses at the
experiments' full size to rtol 1e-4 (the sparse Gibbs slice to 5e-4, for
the reason at ``RTOL_STEP0_GIBBS``), and the sparse Gibbs slice's step-0
gradients and its float64 trajectory with z frozen to the pinned float32
and float64 runs, the card's criteria in ``chip_smoke.py``.
"""

from pathlib import Path
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nonstationary_precip_tpu.experiments import sgpr_bench as jax_sgpr_bench
from nonstationary_precip_tpu.kernels.inducing import nystrom_root as jax_nystrom_root
from nonstationary_precip_tpu.models.gibbs_gp import GibbsSparseGP as JaxGibbsSparseGP
from nonstationary_precip_tpu.models.sgpr import SGPR as JaxSGPR
from nonstationary_precip_tpu.ops.kmeans import kmeans_inducing_points as jax_kmeans
from nonstationary_precip_tpu.priors import LogNormalProcess as JaxLogNormalProcess

from nonstationary_precip_tpu_torch import interop
from nonstationary_precip_tpu_torch.data.datasets import load_uib_spatial, spatio_temporal_month_split
from nonstationary_precip_tpu_torch.experiments import sgpr_bench, spatial_gibbs
from nonstationary_precip_tpu_torch.experiments import spatio_temporal as st_exp
from nonstationary_precip_tpu_torch.kernels.inducing import (
    inducing_added_loss_term,
    nystrom_root,
    sgpr_diag_correction,
)
from nonstationary_precip_tpu_torch.ops.kmeans import kmeans_inducing_points
from nonstationary_precip_tpu_torch.train.config import ExperimentConfig
from nonstationary_precip_tpu_torch.train.vmapped import fit_splits, stack_modules

torch.set_num_threads(1)

F64 = torch.float64
CPU = torch.device("cpu")
REF = Path(__file__).resolve().parent / "fixtures" / "jax_sparse_ref.npz"
RTOL_STEP0 = 1e-4
# The sparse Gibbs slice's float32 loss at init: JAX's and the port's sit
# 1.7e-3–4.0e-3 from the float64 loss (K_zz of 250 k-means centres is
# numerically singular in float32: both take safe_cholesky's first jitter
# rung) and 1.0e-5–1.5e-4 from each other; the port's own moves by up to
# 3.2e-5 between 1 and 4 CPU threads.  The ST model and SGPR agree to 2e-6.
RTOL_STEP0_GIBBS = 5e-4


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


def jax_loss_grad_pred(m, x, y, xs):
    """The JAX model's loss, its gradient pytree and its predictive (mean,
    cov) at xs, in one jitted call (JAX's eager dispatch takes seconds)."""
    loss, g, mean, cov = _jax_loss_grad_pred(m, *(jnp.asarray(a) for a in (x, y, xs)))
    return loss, g, SimpleNamespace(mean=mean, cov=cov)


def assert_grads_match(model, grads_j, rtol=1e-8):
    """Every leaf's gradient of the JAX loss against the port's, for the
    parameters that require grad in the port (the rest are frozen)."""
    ours = {n: p.grad for n, p in model.named_parameters() if p.requires_grad}
    ref = jax_leaves(grads_j)
    assert ours and set(ours) <= set(ref), sorted(set(ours) - set(ref))
    for name, g in ours.items():
        r = ref[name]
        np.testing.assert_allclose(g.numpy(), r, rtol=rtol, atol=1e-11 * max(np.abs(r).max(), 1.0), err_msg=name)


@pytest.mark.parametrize("n,m,d", [(40, 12, 2), (10, 15, 3)], ids=["spread", "duplicate_centres"])
def test_kmeans_matches_jax_given_its_first_row(n, m, d):
    """JAX's seed row fed to the port: the same centres in float64.  With
    more centres than rows the farthest-point order repeats row 0 and the
    duplicates stay empty through Lloyd, on both sides (ties go to the
    first index)."""
    rng = np.random.default_rng(n)
    x = rng.normal(size=(n, d)) * np.array([1.0, 3.0, 0.5][:d]) + 2.0
    key = jax.random.PRNGKey(173 + n)
    first = int(jax.random.randint(key, (), 0, n))
    ref = np.asarray(jax_kmeans(key, jnp.asarray(x), m))
    ours = kmeans_inducing_points(first, t64(x), m).numpy()
    np.testing.assert_allclose(ours, ref, rtol=1e-10, atol=1e-12)
    if m > n:
        assert len(np.unique(ours, axis=0)) < m  # duplicated centres, as in JAX


def test_nystrom_root_and_trace_terms_match_jax():
    rng = np.random.default_rng(3)
    x, z = rng.normal(size=(30, 2)), rng.normal(size=(9, 2))
    k = lambda a, b: np.exp(-0.5 * ((a[:, None] - b[None]) ** 2).sum(-1))  # noqa: E731
    root_j, l_j = jax_nystrom_root(jnp.asarray(k(x, z)), jnp.asarray(k(z, z)))
    root, l_zz = nystrom_root(t64(k(x, z)), t64(k(z, z)))
    np.testing.assert_allclose(root.numpy(), np.asarray(root_j), rtol=1e-10, atol=1e-13)
    np.testing.assert_allclose(l_zz.numpy(), np.asarray(l_j), rtol=1e-10, atol=1e-13)
    from nonstationary_precip_tpu.kernels import inducing as ji

    kd = np.ones(30)
    np.testing.assert_allclose(sgpr_diag_correction(t64(kd), root).numpy(),
                               np.asarray(ji.sgpr_diag_correction(jnp.asarray(kd), root_j)), rtol=1e-10, atol=1e-14)
    np.testing.assert_allclose(float(inducing_added_loss_term(t64(kd), root, t64(0.3))),
                               float(ji.inducing_added_loss_term(jnp.asarray(kd), root_j, 0.3)), rtol=1e-10)
    # a stack of roots is the per-member roots
    stack, _ = nystrom_root(torch.stack([t64(k(x, z))] * 2), torch.stack([t64(k(z, z))] * 2))
    assert torch.equal(stack[1], stack[0]) and torch.allclose(stack[0], root, rtol=1e-12)


def _sgpr_pair(rng, n=40, m=12):
    x = rng.normal(size=(n, 3))
    y = np.sin(2 * x[:, 1]) + np.cos(x[:, 0]) + 0.1 * rng.normal(size=n)
    z = x[rng.permutation(n)[:m]] + 0.05 * rng.normal(size=(m, 3))
    jm = JaxSGPR.create(jax_sgpr_bench.make_kernel(jnp.float64), jnp.asarray(z), noise=0.2, dtype=jnp.float64)
    leaves = {k: v + 0.1 * rng.normal(size=np.shape(v)) for k, v in jax_leaves(jm).items() if k != "z"}
    jm = jax.tree_util.tree_unflatten(jax.tree_util.tree_structure(jm),
                                      [jnp.asarray(leaves.get(k, v)) for k, v in jax_leaves(jm).items()])
    tm = interop.sgpr_from_jax(jax_leaves(jm), sgpr_bench.make_kernel(F64), CPU, F64)
    return jm, tm, x, y


def test_sgpr_loss_gradients_and_predictive_match_jax():
    rng = np.random.default_rng(11)
    jm, tm, x, y = _sgpr_pair(rng)
    xs = rng.normal(size=(15, 3))
    loss_j, g_j, pred_j = jax_loss_grad_pred(jm, x, y, xs)
    loss = tm.loss(t64(x), t64(y))
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(loss_j), rtol=1e-10)
    assert tm.z.grad is not None  # every parameter trains, z included
    assert_grads_match(tm, g_j)
    with torch.no_grad():
        pred = tm.predictive(t64(x), t64(y), t64(xs))
    np.testing.assert_allclose(pred.mean.numpy(), np.asarray(pred_j.mean), rtol=1e-8, atol=1e-10)
    np.testing.assert_allclose(pred.cov.numpy(), np.asarray(pred_j.cov), rtol=1e-8, atol=1e-10)
    assert not tm.trainable(train_z=False).z.requires_grad and tm.kernel.kernels[0].raw_outputscale.requires_grad


def _gibbs_sparse_pair(rng, n=40, m=12, scale_correction=False):
    x = rng.normal(size=(n, 2))
    y = np.sin(2 * x[:, 0]) + 0.1 * rng.normal(size=n)
    z = x[rng.permutation(n)[:m]]
    prior = JaxLogNormalProcess.create(input_dim=2, mean=np.log(0.3), outputscale=1.0, lengthscale=1.3,
                                       dtype=jnp.float64)
    jm = JaxGibbsSparseGP.create(jnp.asarray(z), prior, noise=0.05, outputscale=0.644, dtype=jnp.float64)
    jm = jm.replace(log_ell_z=jm.log_ell_z + 0.2 * jnp.asarray(rng.normal(size=(m, 2))),
                    scale_correction=scale_correction)
    tm = interop.gibbs_sparse_from_jax(jax_leaves(jm), CPU, F64, scale_correction=scale_correction)
    return jm, tm, x, y


@pytest.mark.parametrize("scale_correction", [False, True])
def test_gibbs_sparse_loss_gradients_and_predictive_match_jax(scale_correction):
    """Value and gradients w.r.t. every leaf (noise, outputscale and the
    prior too: frozen in training, their pullbacks must still be right)."""
    rng = np.random.default_rng(29)
    jm, tm, x, y = _gibbs_sparse_pair(rng, scale_correction=scale_correction)
    xs = rng.normal(size=(15, 2))
    loss_j, g_j, pred_j = jax_loss_grad_pred(jm, x, y, xs)
    for p in tm.parameters():
        p.requires_grad_(True)
    loss = tm.loss(t64(x), t64(y))
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(loss_j), rtol=1e-10)
    assert_grads_match(tm, g_j)
    with torch.no_grad():
        pred = tm.predictive(t64(x), t64(y), t64(xs))
    np.testing.assert_allclose(pred.mean.numpy(), np.asarray(pred_j.mean), rtol=1e-8, atol=1e-10)
    np.testing.assert_allclose(pred.cov.numpy(), np.asarray(pred_j.cov), rtol=1e-8, atol=1e-10)
    # the default trainability: the latent field and z train, nothing else
    tm.trainable()
    assert [n for n, p in tm.named_parameters() if p.requires_grad] == ["z", "log_ell_z"]


def test_stacked_sparse_loss_and_predictive_are_the_per_split_ones():
    """A split-stacked GibbsSparseGP (the experiment's) gives each split's
    own loss, gradient and predictive, and equals JAX's vmap of the loss."""
    rng = np.random.default_rng(41)
    pairs = [_gibbs_sparse_pair(rng) for _ in range(3)]
    xs = rng.normal(size=(15, 2))
    stacked = stack_modules([p[1] for p in pairs])
    x, y = t64(np.stack([p[2] for p in pairs])), t64(np.stack([p[3] for p in pairs]))
    per = stacked.loss(x, y)
    torch.sum(per).backward()
    stacked_j = jax.tree_util.tree_map(lambda *a: jnp.stack(a), *[p[0] for p in pairs])
    ref = jax.jit(jax.vmap(lambda m, xx, yy: m.loss(xx, yy)))(stacked_j, jnp.asarray(x.numpy()),
                                                               jnp.asarray(y.numpy()))
    np.testing.assert_allclose(per.detach().numpy(), np.asarray(ref), rtol=1e-10)
    pred = stacked.predictive(x, y, torch.stack([t64(xs)] * 3))
    for k, (_, tm, xk, yk) in enumerate(pairs):
        one = tm.loss(t64(xk), t64(yk))
        one.backward()
        np.testing.assert_allclose(float(per[k].detach()), float(one.detach()), rtol=1e-12)
        np.testing.assert_allclose(stacked.log_ell_z.grad[k].numpy(), tm.log_ell_z.grad.numpy(), rtol=1e-10,
                                   atol=1e-13)
        with torch.no_grad():
            p1 = tm.predictive(t64(xk), t64(yk), t64(xs))
        np.testing.assert_allclose(pred.mean[k].detach().numpy(), p1.mean.numpy(), rtol=1e-10, atol=1e-12)


def _pinned():
    return np.load(REF)


def test_pinned_fixture_is_small_and_whole():
    assert REF.stat().st_size < 1_000_000
    ref = _pinned()
    assert ref["gibbs.losses"].shape == (int(ref["steps"]), 10) and ref["gibbs.z"].shape == (10, 250, 2)
    assert ref["st.z"].shape == (100, 3) and ref["sgpr.z"].shape == (1900, 3)


def test_port_step0_losses_match_pinned_jax_runs():
    """The port's float32 losses at the experiments' own init, fed JAX's z,
    against the pinned JAX float32 step-0 losses: the sparse Gibbs slice's
    10 splits, the ST nonstationary model and SGPR (whose z the port draws
    itself, bit for bit JAX's)."""
    ref = _pinned()
    cfg = ExperimentConfig(inference="sparse", device="cpu")
    _, x, y = load_uib_spatial()
    xn, yn = (x - x.mean(0)) / x.std(0, ddof=1), (y - y.mean()) / y.std(ddof=1)
    models, xs, ys = [], [], []
    for s in range(10):
        model, (x_tr, y_tr, _, _) = spatial_gibbs.make_split(xn, yn, s, cfg, torch.float32, CPU)
        with torch.no_grad():
            model.z.copy_(torch.as_tensor(ref["gibbs.z"][s]))
            model.log_ell_z.copy_(model.prior.init_log_field(model.z))
        models.append(model)
        xs.append(x_tr)
        ys.append(y_tr)
    with torch.no_grad():
        per = stack_modules(models).loss(torch.stack(xs), torch.stack(ys)).numpy()
    np.testing.assert_allclose(per, ref["gibbs.losses"][0], rtol=RTOL_STEP0_GIBBS)

    st_cfg = st_exp.default_config().parse_args(["--model", "Non-Stationary", "--num_inducing", "100"])
    x_tr, y_tr, *_ = spatio_temporal_month_split()
    x_tr, y_tr = torch.as_tensor(x_tr, dtype=torch.float32), torch.as_tensor(y_tr, dtype=torch.float32)
    model = st_exp.make_model(st_cfg, x_tr)
    with torch.no_grad():
        model.z.copy_(torch.as_tensor(ref["st.z"]))
        model.log_ell_z.copy_(model.prior.init_log_field(model.z[:, [1, 2]]))
        np.testing.assert_allclose(float(model.loss(x_tr, y_tr)), float(ref["st.losses"][0]), rtol=RTOL_STEP0)

    train_x, train_y, _, _, z = sgpr_bench.prepare(sgpr_bench.default_config())
    np.testing.assert_array_equal(z.numpy(), ref["sgpr.z"])
    model = interop.SGPR.create(sgpr_bench.make_kernel(), z)
    with torch.no_grad():
        np.testing.assert_allclose(float(model.loss(train_x, train_y)), float(ref["sgpr.losses"][0]),
                                   rtol=RTOL_STEP0)


def _pinned_gibbs_splits(ref, splits, dtype):
    """The sparse Gibbs slice's ``splits`` at the pinned init (JAX's z, the
    prior's field there), in ``dtype`` on the CPU, stacked."""
    cfg = ExperimentConfig(inference="sparse", device="cpu")
    _, x, y = load_uib_spatial()
    xn, yn = (x - x.mean(0)) / x.std(0, ddof=1), (y - y.mean()) / y.std(ddof=1)
    models, xs, ys = [], [], []
    for s in splits:
        model, (x_tr, y_tr, _, _) = spatial_gibbs.make_split(xn, yn, s, cfg, dtype, CPU)
        with torch.no_grad():
            model.z.copy_(torch.as_tensor(ref["gibbs.z"][s], dtype=dtype))
            model.log_ell_z.copy_(model.prior.init_log_field(model.z))
        models.append(model)
        xs.append(x_tr)
        ys.append(y_tr)
    return models, xs, ys


@pytest.mark.parametrize("dtype,rtol", [(torch.float32, {"z": 5e-2}), (F64, {"z": 1e-4, "log_ell_z": 1e-5})],
                         ids=["float32", "float64"])
def test_sparse_gibbs_step0_gradients_match_pinned_jax(dtype, rtol):
    """Splits 0's and 3's step-0 gradient in z (and, in float64, in the
    field) at the experiment's full size against the pinned JAX run's,
    relative in norm: the check of the z-gradient path that the float32 trajectory's
    drift cannot pass (``chip_smoke.py`` SPARSE_GRAD_RTOL: float32 against
    float64 differs by 63-450 % in z, the two packages' float32 by at most
    2.8e-2 here; the field's float32 gradient carries 9-20 % of rounding in
    either package)."""
    ref = _pinned()
    models, xs, ys = _pinned_gibbs_splits(ref, (0, 3), dtype)
    stacked = stack_modules(models)
    stacked.loss(torch.stack(xs), torch.stack(ys)).sum().backward()
    suffix = "_f64" if dtype == F64 else ""
    for name, tol in rtol.items():
        got = getattr(stacked, name).grad.double().numpy().reshape(2, -1)
        want = ref[f"gibbs.grad0.{name}{suffix}"][[0, 3]].astype(np.float64).reshape(2, -1)
        rel = np.linalg.norm(got - want, axis=1) / np.linalg.norm(want, axis=1)
        assert rel.max() <= tol, (name, rel)


def test_sparse_gibbs_float64_with_z_frozen_follows_pinned_jax_run():
    """With z frozen the float64 trajectory is not chaotic: 20 Adam steps of
    split 3 (whose float32 run parts furthest) from JAX's z stay within
    1e-6 of the pinned JAX float64 run (here 1.6e-10 at step 0, 6e-9 at
    step 19; the float32 runs part by 2.3e-2 in either package, and with z
    training even the float64 runs part by 1.3e-2)."""
    ref = _pinned()
    models, xs, ys = _pinned_gibbs_splits(ref, (3,), F64)
    models[0].z.requires_grad_(False)
    res = fit_splits(models, lambda m, xx, yy: m.loss(xx, yy), xs, ys, lr=0.01, num_steps=int(ref["steps"]))
    want = ref["gibbs.frozen.losses_f64"][:, [3]]
    np.testing.assert_allclose(res.losses[0], want[0], rtol=1e-8)
    np.testing.assert_allclose(res.losses[-1], want[-1], rtol=1e-6)


def _sse(x, z) -> float:
    """The k-means objective: squared distance of each row to its nearest
    centre, summed."""
    return float(((x[:, None, :] - z[None]) ** 2).sum(-1).min(1).sum())


@pytest.mark.parametrize("m", [100, 500], ids=["band_row", "jax_default_duplicates"])
def test_first_centres_and_kmeans_on_the_st_split_match_jax(m):
    """The experiments draw their k-means seed row with numpy.  Given JAX's
    draw (here under x64, another row than the pinned float32 run's), the
    port's k-means runs on the ST split's 172 training rows in float64.
    At the JAX default of 500 centres both take every row once and repeat
    one row 328 times: the same centres, bit for bit, as JAX's.  At the
    band row's 100 the 4 months share their 43 sites, so the farthest-point
    order meets exact ties, which one ulp of the column deviation (XLA's
    and torch's sums round apart) breaks either way: the two runs reach
    100 distinct centres with objectives within 5 % of each other (3.154
    and 3.224), where a random spread matches JAX to 1e-10
    (test_kmeans_matches_jax_given_its_first_row).  The card's runs are fed
    JAX's z."""
    assert spatial_gibbs.first_centre(0, 316) == int(np.random.default_rng(173).integers(316))
    assert 0 <= st_exp.first_centre(172) < 172
    assert 0 <= int(_pinned()["st.first"]) < 172
    first = int(jax.random.randint(jax.random.PRNGKey(173), (), 0, 172))
    x_tr = spatio_temporal_month_split()[0]
    z_j = np.asarray(jax_kmeans(jax.random.PRNGKey(173), jnp.asarray(x_tr), m))
    z = kmeans_inducing_points(first, t64(x_tr), m).numpy()
    if m > len(x_tr):
        np.testing.assert_array_equal(np.unique(z, axis=0), np.unique(z_j, axis=0))
        np.testing.assert_array_equal(np.unique(z, axis=0), np.unique(x_tr, axis=0))
        np.testing.assert_array_equal(z[len(x_tr):], z_j[len(x_tr):])
    else:
        assert len(np.unique(z, axis=0)) == len(np.unique(z_j, axis=0)) == m
        assert abs(_sse(x_tr, z) - _sse(x_tr, z_j)) <= 0.05 * _sse(x_tr, z_j)
