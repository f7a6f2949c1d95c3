"""The dense CG solver against the JAX package, float64 on the CPU:
``ops/bbmm.cg_mll`` (value, and the gradients its custom VJP gives ``kmat``,
``y`` and ``sigma2``) and ``ExactGP``'s ``solver='cg'`` without ``block``
(``mll`` with every leaf's gradient, ``posterior`` and ``predictive``).

The port takes its probe draws from the caller; the tests make them as the
JAX package makes them from its key: ``rademacher(key, (N, R))`` without a
preconditioner, ``split(key)`` into ``normal(k1, (rank, R))`` and
``normal(k2, (N, R))`` with one (``bbmm.sample_precond_probes``).  Both
sides then run the same mBCG iterations on the same operator, so values and
gradients agree to 1e-10 relative to each array's largest entry, at budgets
short of the point where Lanczos loses orthogonality: on this K (σ² 0.05,
N = 80, unpreconditioned) the two implementations' rounding parts by 7e-8
at 15 iterations and 3e-5 at 20, so the MLL cases run 10 (as
``tests/test_torch_exact_gp.py``'s matrix-free cases run 8), and one case
runs a preconditioned solve to convergence, where every column freezes.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nonstationary_precip_tpu import kernels as jk
from nonstationary_precip_tpu.models import ExactGP as JExactGP
from nonstationary_precip_tpu.ops import bbmm as jbbmm
from nonstationary_precip_tpu_torch import interop
from nonstationary_precip_tpu_torch.kernels.base import Scale
from nonstationary_precip_tpu_torch.kernels.stationary import RBF
from nonstationary_precip_tpu_torch.ops import bbmm

torch.set_num_threads(1)
F64 = torch.float64
N, PROBES, ITERS, TOL = 80, 6, 10, 1e-6


def _close(got, ref, rtol=1e-10):
    got, ref = np.asarray(got, dtype=np.float64), np.asarray(ref, dtype=np.float64)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    np.testing.assert_allclose(got, ref, rtol=0, atol=rtol * max(np.abs(ref).max(), 1e-300))


def jax_probe_noise(key, n, num, rank):
    """The draws JAX's ``cg_mll`` makes from ``key``, as the port takes them."""
    if rank == 0:
        return np.asarray(jax.random.rademacher(key, (n, num), dtype=jnp.float64))
    k1, k2 = jax.random.split(key)
    return (np.asarray(jax.random.normal(k1, (rank, num), jnp.float64)),
            np.asarray(jax.random.normal(k2, (n, num), jnp.float64)))


def torch_noise(noise):
    return tuple(torch.tensor(a) for a in noise) if isinstance(noise, tuple) else torch.tensor(noise)


def _problem(seed=3, n=N):
    rng = np.random.default_rng(seed)
    x = rng.uniform(-2, 2, size=(n, 2))
    y = np.sin(2 * x[:, 0]) * np.cos(x[:, 1]) + 0.1 * rng.normal(size=n)
    return x, y


def _kmat(x, ell=0.8, s2=0.05):
    d2 = ((x[:, None, :] - x[None, :, :]) ** 2).sum(-1)
    return 1.2 * np.exp(-0.5 * d2 / ell**2) + s2 * np.eye(len(x)), s2


@pytest.mark.parametrize("rank,s2,iters", [(0, 0.05, ITERS), (8, 0.05, ITERS), (8, 0.5, 40)])
def test_cg_mll_value_and_gradients_match_jax(rank, s2, iters):
    """The value, d/dkmat (the symmetrised trace-identity cotangent) and
    d/dy on JAX's probe draws; d/dsigma2 an exact zero in sigma2's dtype.
    The last case converges every column (σ² 0.5, 40 iterations)."""
    x, y = _problem()
    kmat, s2 = _kmat(x, s2=s2)
    key = jax.random.PRNGKey(11)

    def jf(k, yy):
        return jbbmm.cg_mll(k, yy, key, jnp.float64(s2), PROBES, iters, TOL, rank)

    vj, (gk, gy) = jax.value_and_grad(jf, argnums=(0, 1))(jnp.asarray(kmat), jnp.asarray(y))
    k_t = torch.tensor(kmat, requires_grad=True)
    y_t = torch.tensor(y, requires_grad=True)
    s2_t = torch.tensor(s2, dtype=F64, requires_grad=True)
    val = bbmm.cg_mll(k_t, y_t, torch_noise(jax_probe_noise(key, N, PROBES, rank)), s2_t, max_iters=iters, tol=TOL,
                      precond_rank=rank)
    val.backward()
    _close(val.detach(), vj)
    _close(k_t.grad, gk)
    _close(y_t.grad, gy)
    assert s2_t.grad is not None and s2_t.grad.dtype == F64 and float(s2_t.grad) == 0.0
    np.testing.assert_array_equal(k_t.grad.numpy(), k_t.grad.numpy().T)


def test_cg_mll_breakdown_is_nan_as_in_jax():
    """An indefinite kmat breaks CG while the residual is large: NaN in both."""
    x, y = _problem(n=40)
    kmat, s2 = _kmat(x)
    kmat = kmat - 0.5 * np.eye(40)
    key = jax.random.PRNGKey(12)
    vj = jbbmm.cg_mll(jnp.asarray(kmat), jnp.asarray(y), key, jnp.float64(s2), 4, 30, TOL, 0)
    vp = bbmm.cg_mll(torch.tensor(kmat), torch.tensor(y), torch_noise(jax_probe_noise(key, 40, 4, 0)), s2,
                     max_iters=30, tol=TOL)
    assert np.isnan(float(vj)) and torch.isnan(vp)


def _models(mean_type="constant"):
    jm = JExactGP.create(jk.Scale.create(jk.RBF.create(2, lengthscale=jnp.array([0.7, 1.1])), outputscale=1.3),
                         noise=0.1, mean_type=mean_type, dtype=jnp.float64)
    jm = jax.tree.map(lambda v: jnp.asarray(v, jnp.float64) + 0.03, jm)
    params = {jax.tree_util.keystr(p)[1:].replace("[", ".").replace("]", ""): np.asarray(v)
              for p, v in jax.tree_util.tree_flatten_with_path(jm)[0]}
    pm = interop.exact_gp_from_jax(params, Scale.create(RBF.create(2, dtype=F64), dtype=F64), "cpu", F64)
    return jm, pm, params


@pytest.mark.parametrize("rank", [0, 10])
def test_exact_gp_dense_cg_mll_and_every_gradient_match_jax(rank):
    """``ExactGP.mll(solver='cg')`` without block, the value and every
    leaf's gradient (through the Gram's autograd to ℓ, s², the noise and
    the mean), on JAX's probe draws."""
    jm, pm, _ = _models()
    x, y = _problem()
    key = jax.random.PRNGKey(13)

    def jmll(m):
        return m.mll(jnp.asarray(x), jnp.asarray(y), solver="cg", key=key, num_probes=PROBES, max_iters=ITERS,
                     precond_rank=rank)

    vj, gj = jax.value_and_grad(jmll)(jm)
    grads = {jax.tree_util.keystr(p)[1:].replace("[", ".").replace("]", ""): np.asarray(v)
             for p, v in jax.tree_util.tree_flatten_with_path(gj)[0]}
    val = pm.mll(torch.tensor(x), torch.tensor(y), solver="cg", probe_noise=torch_noise(jax_probe_noise(key, N, PROBES,
                                                                                                         rank)),
                 max_iters=ITERS, precond_rank=rank)
    val.backward()
    _close(val.detach(), vj)
    named = dict(pm.named_parameters())
    assert sorted(named) == sorted(grads)
    for name, g in grads.items():
        _close(named[name].grad, g)


@pytest.mark.parametrize("rank", [0, 10])
def test_exact_gp_dense_cg_posterior_and_predictive_match_jax(rank):
    """``posterior`` and ``predictive`` with ``solver='cg'`` (one mBCG over
    [resid, K_x*], no probes) against JAX's at 5 iterations (the
    preconditioned covariance parts by 8e-12 at 8 and 3e-10 at 10, the
    rounding growing as above), and a converged solve (200 iterations, tol
    1e-10) within 1e-6 of the Cholesky predictive."""
    jm, pm, _ = _models()
    x, y = _problem()
    xs = np.random.default_rng(14).uniform(-2, 2, size=(17, 2))
    args = (jnp.asarray(x), jnp.asarray(y), jnp.asarray(xs))
    targs = (torch.tensor(x), torch.tensor(y), torch.tensor(xs))
    kw = dict(solver="cg", max_iters=5, precond_rank=rank)
    with torch.no_grad():
        post = pm.posterior(*targs, **kw)
        pred = pm.predictive(*targs, **kw)
        converged = pm.predictive(*targs, solver="cg", max_iters=200, tol=1e-10, precond_rank=rank)
        chol = pm.predictive(*targs)
    for got, ref in ((post, jm.posterior(*args, **kw)), (pred, jm.predictive(*args, **kw))):
        _close(got.mean, ref.mean)
        _close(got.cov, ref.cov)
    _close(converged.mean, chol.mean, 1e-6)
    _close(converged.cov, chol.cov, 1e-6)
