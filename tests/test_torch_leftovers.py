"""The small library leftovers of the port against their JAX functions,
float64 on the CPU: ``Matern52``, ``linalg.solve_psd`` and
``robust_logdet``, ``LearnedSoftPlus``, ``DiagNormal.sample``,
``MVN.marginals`` and ``MVN.sample`` (from JAX's own draws),
``BoxCox.inverse``, ``load_netcdf_precip``, ``vmapped.fit_restarts``,
``utils/functional``, ``train/logging`` and ``train/profiling``.

Values and gradients agree to 1e-10 relative to each array's largest entry
(the same float64 formulas in another framework); ``fit_restarts`` runs 5
Adam steps on each side, and agrees to 1e-10 as well.
"""

import json
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nonstationary_precip_tpu import kernels as jk
from nonstationary_precip_tpu.data import dataprep as jdataprep
from nonstationary_precip_tpu.models import ExactGP as JExactGP
from nonstationary_precip_tpu.models import distributions as jdist
from nonstationary_precip_tpu.ops import linalg as jlinalg
from nonstationary_precip_tpu.train import logging as jlogging
from nonstationary_precip_tpu.train import vmapped as jvmapped
from nonstationary_precip_tpu.utils import functional as jfn
from nonstationary_precip_tpu.utils.transforms import LearnedSoftPlus as JLearnedSoftPlus
from nonstationary_precip_tpu_torch import interop
from nonstationary_precip_tpu_torch.data import dataprep
from nonstationary_precip_tpu_torch.experiments import precipitation_baselines as pb
from nonstationary_precip_tpu_torch.kernels.base import Scale
from nonstationary_precip_tpu_torch.kernels.stationary import RBF, Matern52
from nonstationary_precip_tpu_torch.models import distributions
from nonstationary_precip_tpu_torch.ops import linalg
from nonstationary_precip_tpu_torch.train import logging as tlogging
from nonstationary_precip_tpu_torch.train import profiling
from nonstationary_precip_tpu_torch.train.vmapped import fit_restarts
from nonstationary_precip_tpu_torch.utils import functional as fn
from nonstationary_precip_tpu_torch.utils.transforms import LearnedSoftPlus

torch.set_num_threads(1)
F64 = torch.float64


def _close(got, ref, rtol=1e-10):
    got, ref = np.asarray(got, dtype=np.float64), np.asarray(ref, dtype=np.float64)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    np.testing.assert_allclose(got, ref, rtol=0, atol=rtol * max(np.abs(ref).max(), 1e-300))


def _t(a, grad=False):
    return torch.tensor(np.asarray(a), dtype=F64, requires_grad=grad)


def _spd(rng, n, ridge=1.0):
    a = rng.normal(size=(n, n))
    return a @ a.T + ridge * np.eye(n)


def test_matern52_gram_and_gradients_match_jax():
    """The Gram (with the d = 0 diagonal) and its gradients w.r.t. the raw
    lengthscale and both inputs."""
    rng = np.random.default_rng(1)
    x1, x2, raw = rng.normal(size=(7, 3)), rng.normal(size=(5, 3)), rng.normal(size=3)
    w = rng.normal(size=(7, 5))

    def jf(r, a, b):
        k = jk.Matern52(raw_lengthscale=r)
        return jnp.sum(k(a, b) * w), k(a, a)

    (vj, kaa), gj = jax.value_and_grad(jf, argnums=(0, 1, 2), has_aux=True)(jnp.asarray(raw), jnp.asarray(x1),
                                                                              jnp.asarray(x2))
    k = Matern52(_t(raw))
    a, b = _t(x1, True), _t(x2, True)
    val = torch.sum(k(a, b) * _t(w))
    val.backward()
    _close(val.detach(), vj)
    _close(k(a, a).detach(), kaa)
    for got, ref in zip((k.raw_lengthscale.grad, a.grad, b.grad), gj):
        _close(got, ref)
    assert Matern52.create(2, lengthscale=0.5, dtype=F64).lengthscale.tolist() == pytest.approx([0.5, 0.5])


def test_solve_psd_and_robust_logdet_match_jax():
    """solve_psd with and without jitter (values and gradients); robust_logdet
    on a PD batch, on a singular matrix its escalation repairs, and on a
    negative definite one that stays NaN; its gradient on the batch (JAX's
    loop has none: against slogdet's)."""
    rng = np.random.default_rng(2)
    a, rhs = _spd(rng, 6), rng.normal(size=(6, 2))
    for jitter in (0.0, 0.3):
        def jf(m, r):
            return jnp.sum(jlinalg.solve_psd(m, r, jitter) ** 2)

        vj, gj = jax.value_and_grad(jf, argnums=(0, 1))(jnp.asarray(a), jnp.asarray(rhs))
        m, r = _t(a, True), _t(rhs, True)
        val = torch.sum(linalg.solve_psd(m, r, jitter) ** 2)
        val.backward()
        _close(val.detach(), vj)
        _close(m.grad, gj[0])
        _close(r.grad, gj[1])
    batch = np.stack([_spd(rng, 5), _spd(rng, 5, 0.1)])
    # exactly singular, so that no rounding decides the sign of its
    # determinant: the first regularisation (1e-30) repairs it
    singular = np.diag([1.0, 2.0, 0.0, 3.0])
    for mat in (batch, singular, -_spd(rng, 4)):
        got, ref = linalg.robust_logdet(_t(mat)), np.asarray(jlinalg.robust_logdet(jnp.asarray(mat)))
        np.testing.assert_array_equal(np.isnan(got.numpy()), np.isnan(ref))
        _close(np.nan_to_num(got.numpy()), np.nan_to_num(ref))
    assert np.isfinite(float(linalg.robust_logdet(_t(singular))))
    # JAX's while-loop has no reverse mode; where no regularisation is
    # needed its value is slogdet's, whose gradient the port's must be
    m = _t(batch, True)
    torch.sum(linalg.robust_logdet(m)).backward()
    _close(m.grad, jax.grad(lambda mm: jnp.sum(jnp.linalg.slogdet(mm)[1]))(jnp.asarray(batch)))


def test_learned_softplus_matches_jax():
    """Both branches (βx below and above 20) and the gradients w.r.t. x and
    log β, finite past exp's overflow."""
    x = np.array([-3.0, -0.5, 0.0, 0.7, 4.0, 25.0, 1e3])
    for beta in (0.5, 2.0):
        jm = JLearnedSoftPlus.create(beta, dtype=jnp.float64)

        def jf(lb, xx):
            return jnp.sum(JLearnedSoftPlus(log_beta=lb)(xx) ** 2)

        vj, (glb, gx) = jax.value_and_grad(jf, argnums=(0, 1))(jm.log_beta, jnp.asarray(x))
        pm = LearnedSoftPlus.create(beta, dtype=F64)
        xt = _t(x, True)
        val = torch.sum(pm(xt) ** 2)
        val.backward()
        _close(pm(xt).detach(), jm(jnp.asarray(x)))
        _close(val.detach(), vj)
        _close(pm.log_beta.grad, glb)
        _close(xt.grad, gx)
        assert torch.isfinite(xt.grad).all()


def test_distribution_sampling_matches_jax_draws():
    """DiagNormal.sample and MVN.sample from the draws JAX makes from its
    key, and MVN.marginals."""
    rng = np.random.default_rng(3)
    mean, var, cov = rng.normal(size=6), rng.uniform(0.1, 2.0, size=6), _spd(rng, 6)
    key = jax.random.PRNGKey(4)
    eps = np.array(jax.random.normal(key, (3, 6), jnp.float64))
    dn = distributions.DiagNormal(_t(mean), _t(var))
    _close(dn.sample(_t(eps)), jdist.DiagNormal(jnp.asarray(mean), jnp.asarray(var)).sample(key, 3))
    jm = jdist.MVN(jnp.asarray(mean), jnp.asarray(cov))
    pm = distributions.MVN(_t(mean), _t(cov))
    _close(pm.sample(_t(eps)), jm.sample(key, 3))
    marg, jmarg = pm.marginals(), jm.marginals()
    _close(marg.mean, jmarg.mean)
    _close(marg.var, jmarg.var)
    batched = distributions.MVN(_t(np.stack([mean, mean])), _t(np.stack([cov, cov])))
    draws = batched.sample(_t(np.stack([eps, eps], axis=1)))
    assert draws.shape == (3, 2, 6)
    _close(draws[:, 1], jm.sample(key, 3))


def test_box_cox_inverse_and_netcdf_loader_match_jax(tmp_path):
    """BoxCox.inverse undoes the transform as JAX's does; without xarray,
    both netCDF loaders raise ImportError."""
    data = dataprep.load_csv(pb.default_config().data)
    got, ref = dataprep.box_cox_transform(data), jdataprep.box_cox_transform(data)
    _close(got.inverse(got.y), ref.inverse(ref.y))
    _close(got.inverse(got.y), data[:, -1])
    try:
        import xarray  # noqa: F401
    except ImportError:
        for loader in (dataprep.load_netcdf_precip, jdataprep.load_netcdf_precip):
            with pytest.raises(ImportError, match="xarray"):
                loader(tmp_path / "p.nc")
    else:
        pytest.skip("xarray is installed: the loader's refusal is not reached")


def test_fit_restarts_matches_jax():
    """Three SE-ARD ExactGP restarts trained as one stacked model for 5
    Adam steps: each restart's final loss, the best index and its loss."""
    rng = np.random.default_rng(5)
    x = rng.uniform(-2, 2, size=(30, 2))
    y = np.sin(2 * x[:, 0]) + 0.1 * rng.normal(size=30)
    jms = [JExactGP.create(jk.Scale.create(jk.RBF.create(2, lengthscale=jnp.array(ls)), outputscale=s),
                           noise=n, dtype=jnp.float64)
           for ls, s, n in (([0.3, 0.4], 0.5, 0.3), ([1.0, 1.5], 1.2, 0.05), ([3.0, 3.0], 2.0, 1.0))]
    jms = [jax.tree.map(lambda v: jnp.asarray(v, jnp.float64), m) for m in jms]
    xx, yy = jnp.asarray(x), jnp.asarray(y)
    jbest, jloss, jfinals = jvmapped.fit_restarts(jms, lambda m: m.loss(xx, yy), lr=0.05, num_steps=5)

    def port(jm):
        params = {jax.tree_util.keystr(p)[1:].replace("[", ".").replace("]", ""): np.asarray(v)
                  for p, v in jax.tree_util.tree_flatten_with_path(jm)[0]}
        return interop.exact_gp_from_jax(params, Scale.create(RBF.create(2, dtype=F64), dtype=F64), "cpu", F64)

    best, loss, finals = fit_restarts([port(m) for m in jms], lambda m, a, b: m.loss(a, b), _t(x), _t(y), lr=0.05,
                                      num_steps=5)
    _close(finals, jfinals)
    assert int(np.argmin(finals.numpy())) == int(np.argmin(np.asarray(jfinals)))
    assert loss == pytest.approx(jloss, rel=1e-10)
    _close(best.kernel.base.lengthscale.detach(), jbest.kernel.base.lengthscale)
    with torch.no_grad():
        assert float(best.loss(_t(x), _t(y))) == pytest.approx(loss, rel=1e-12)


def test_functional_matches_jax():
    """Every function of utils/functional on a batch, against JAX's."""
    rng = np.random.default_rng(6)
    a = rng.normal(size=(3, 5, 5))
    v, w = rng.normal(size=(3, 5)), rng.normal(size=(3, 5))
    spd = np.stack([_spd(rng, 5) for _ in range(3)])
    y = rng.normal(size=(20, 4))
    c, d = rng.normal(size=(4, 2)), rng.normal(size=4)
    aj, vj, wj, sj = (jnp.asarray(t) for t in (a, v, w, spd))
    at, vt, wt, st = (_t(t) for t in (a, v, w, spd))
    pairs = [
        (fn.dot(vt, wt), jfn.dot(vj, wj)), (fn.t(at), jfn.t(aj)), (fn.tr(at), jfn.tr(aj)),
        (fn.mv(at, vt), jfn.mv(aj, vj)), (fn.mv(st, vt, invert=True), jfn.mv(sj, vj, invert=True)),
        (fn.quad(vt, at, wt), jfn.quad(vj, aj, wj)), (fn.quad(vt, st, invert=True), jfn.quad(vj, sj, invert=True)),
        (fn.expquad(0.1 * vt, st), jfn.expquad(0.1 * vj, sj)),
        (fn.expquad(vt, st, invert=True, out_scale=2.0, exp_scale=0.3),
         jfn.expquad(vj, sj, invert=True, out_scale=2.0, exp_scale=0.3)),
        (fn.sym(at), jfn.sym(aj)), (fn.op(vt), jfn.op(vj)), (fn.op(vt, wt), jfn.op(vj, wj)),
        (fn.vec(at[:, :, :3]), jfn.vec(aj[:, :, :3])), (fn.vech(at), jfn.vech(aj)),
        (fn.kron(at[:, :2, :3], at[:, 1:4, :2]), jfn.kron(aj[:, :2, :3], aj[:, 1:4, :2])),
        (fn.duplication_matrix(4, F64), jfn.duplication_matrix(4)),
        (fn.diff(at), jfn.diff(aj)), (fn.diff(at, dim=-1), jfn.diff(aj, dim=-1)),
        (fn.diff(at, boundary_value=_t(np.zeros((3, 5)))), jfn.diff(aj, boundary_value=jnp.zeros((3, 5)))),
        (fn.normalise(at), jfn.normalise(aj)), (fn.normalise(at, axis=-2), jfn.normalise(aj, axis=-2)),
        (fn.robust_logdet(st), jfn.robust_logdet(sj)),
    ]
    for got, ref in pairs:
        _close(got, ref)
    # the PCA basis up to each direction's sign (eigh's sign is its LAPACK's)
    got, ref = fn.project_pca(2, _t(y)), jfn.project_pca(2, jnp.asarray(y))
    sign = np.sign(np.sum(got.matrix.numpy() * np.asarray(ref.matrix), axis=-1))
    _close(got.matrix.numpy() * sign[:, None], ref.matrix)
    _close(got.projection.numpy() * sign[None, :], ref.projection)
    got, ref = fn.project_lstsq(_t(y), _t(c), _t(d)), jfn.project_lstsq(jnp.asarray(y), jnp.asarray(c), jnp.asarray(d))
    _close(got.projection, ref.projection)
    grid = np.array([0.0, 0.5, 1.0, 1.5])
    for value in (0.5, 0.7, 2.0, -1.0):
        assert fn.bisect_right(grid, value) == jfn.bisect_right(grid, value)
        assert fn.bisect_left(grid, value) == jfn.bisect_left(grid, value)
    with pytest.raises(ValueError, match="square"):
        fn.vech(at[:, :, :3])


def test_param_table_and_trainable_names_match_jax_layout(tmp_path):
    """The driver's sparse Gibbs model: the table's header, rule, rows (JAX
    names with '/' as the port's '.') and trainable total equal JAX's for
    the same model and mask; the trainable names likewise."""
    from nonstationary_precip_tpu.models import GibbsSparseGP as JSparse
    from nonstationary_precip_tpu.priors import LogNormalProcess as JPrior

    z = np.random.default_rng(7).normal(size=(12, 2))
    jm = JSparse.create(jnp.asarray(z, jnp.float32),
                        JPrior.create(2, mean=math.log(0.3), outputscale=1.0, lengthscale=1.3),
                        noise=0.011, outputscale=0.644)
    mask = jm.trainable(train_noise=False, train_scale=True)
    cfg = pb.default_config().parse_args(["--inference", "sparse", "--num_inducing", "12", "--scale", "0"])
    pm = pb.build_model(cfg, torch.tensor(z, dtype=torch.float32))
    got = tlogging.param_table(pm).splitlines()
    ref = jlogging.param_table(jm, mask).replace("/", ".").splitlines()
    assert got[:2] == ref[:2] and got[-1] == ref[-1] and sorted(got[2:-1]) == sorted(ref[2:-1])
    assert sorted(tlogging.trainable_param_names(pm)) == sorted(
        n.replace("/", ".") for n in jlogging.trainable_param_names(jm, mask))
    logger = tlogging.MetricsLogger(tmp_path, name="m", use_tensorboard=False)
    logger.scalars(3, a=torch.tensor(1.5), b=2)
    logger.scalars(4, a=0.25)
    logger.close()
    recs = [json.loads(line) for line in (tmp_path / "m.jsonl").read_text().splitlines()]
    assert [(r["step"], r["a"]) for r in recs] == [(3, 1.5), (4, 0.25)] and recs[0]["b"] == 2.0


def test_profiling_trace_timer_and_annotation(tmp_path):
    """``trace`` writes a Chrome trace holding an ``annotate`` range; the
    CPU StepTimer counts the steps after its warm-up."""
    with profiling.trace(str(tmp_path / "t")):
        with profiling.annotate("leftover_step"):
            torch.ones(8) @ torch.ones(8)
    assert "leftover_step" in (tmp_path / "t" / "trace.json").read_text()
    timer = profiling.StepTimer(warmup=2)
    assert math.isnan(timer.steps_per_sec())
    for _ in range(5):
        out = torch.ones(4) * 2
        timer.tick(out)
    timer.stop(out)
    assert timer.steps_per_sec() > 0 and timer._count == 5
