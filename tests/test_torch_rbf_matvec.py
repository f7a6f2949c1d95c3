"""K6's plain version (``ops/matvec.rbf_gram_matvec_plain``, through
``rbf_gram_matvec`` and ``stationary_matvec_builder`` on CPU tensors)
against the JAX package's RBF Gram·V kernel, run in Pallas interpret mode
on the CPU as ``tests/test_pallas_matvec.py`` runs it.

Both sides form the quadratic from the ‖a‖² + ‖b‖² − 2a·b identity clamped
at 0 and sum N products in float32 in another order; the band is the JAX
kernel's own test's, rtol 2e-5 / atol 2e-4.  The CUDA kernel forms the
quadratic from the differences and is held to this plain version on the
card (``chip_smoke.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

import nonstationary_precip_tpu.ops.pallas_matvec as pm
from nonstationary_precip_tpu import kernels as jk
from nonstationary_precip_tpu_torch.kernels.base import Scale
from nonstationary_precip_tpu_torch.kernels.stationary import RBF, Periodic
from nonstationary_precip_tpu_torch.ops import matvec

torch.set_num_threads(1)
RTOL, ATOL = 2e-5, 2e-4


def _data(n1, n2, d, r, seed=7):
    rng = np.random.default_rng(seed)
    f32 = np.float32
    return (rng.normal(size=(n1, d)).astype(f32), rng.normal(size=(n2, d)).astype(f32),
            np.exp(0.2 * rng.normal(size=d)).astype(f32), rng.normal(size=(n2, r)).astype(f32))


@pytest.mark.parametrize("n1,n2,d,r", [(130, 70, 2, 5), (600, 1100, 4, 16), (80, 140, 2, 200)])
def test_rbf_matvec_plain_matches_jax_kernel(n1, n2, d, r):
    """JAX's cases (test_pallas_matvec.py:72-86) and R = 200, which the
    CUDA wrapper splits into 128-column launches."""
    x1, x2, ell, v = _data(n1, n2, d, r)
    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(pm.rbf_gram_matvec(jnp.asarray(x1), jnp.asarray(x2), jnp.asarray(ell), jnp.asarray(v)))
    got = matvec.rbf_gram_matvec(*(torch.tensor(a) for a in (x1, x2, ell, v))).numpy()
    assert got.shape == (n1, r)
    np.testing.assert_allclose(got, ref, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("case", ["scale_rbf", "rbf_active_dims"])
def test_stationary_matvec_builder_matches_jax(case):
    rng = np.random.default_rng(3)
    x = rng.normal(size=(300, 3)).astype(np.float32)
    v = rng.normal(size=(300, 9)).astype(np.float32)
    if case == "scale_rbf":
        jkern = jk.Scale.create(jk.RBF.create(3, lengthscale=jnp.array([0.6, 1.0, 1.7])), outputscale=1.8)
        kern = Scale.create(RBF.create(3))
    else:
        jkern = jk.RBF.create(2, lengthscale=jnp.array([0.7, 1.3]), active_dims=(0, 2))
        kern = RBF.create(2, active_dims=(0, 2))
    for path, leaf in jax.tree_util.tree_flatten_with_path(jkern)[0]:
        kern.get_parameter(jax.tree_util.keystr(path)[1:]).data = torch.tensor(np.asarray(leaf))
    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(pm.stationary_matvec_builder(jkern, jnp.asarray(x), 0.3)(jnp.asarray(v)))
    with torch.no_grad():
        got = matvec.stationary_matvec_builder(kern, torch.tensor(x), 0.3)(torch.tensor(v)).numpy()
        dense = (kern(torch.tensor(x)) @ torch.tensor(v) + 0.3 * torch.tensor(v)).numpy()
    np.testing.assert_allclose(got, ref, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got, dense, rtol=RTOL, atol=ATOL)


def test_builder_and_wrappers_refuse_what_they_do_not_take():
    x = torch.randn(16, 9)
    with pytest.raises(TypeError, match="RBF"):
        matvec.stationary_matvec_builder(Periodic.create(2), x[:, :2], 0.1)
    with pytest.raises(TypeError, match="RBF"):
        matvec.stationary_matvec_builder(Scale.create(RBF.create(1) * Periodic.create(1)), x[:, :1], 0.1)
    with pytest.raises(ValueError, match="D ≤ 8"):
        matvec.rbf_gram_matvec(x, x, torch.ones(9), torch.randn(16, 2))
    v = torch.randn(16, 2)
    for precision in ("default", "high3"):  # ported: on the CPU each takes its plain version
        torch.testing.assert_close(matvec.make_rbf_matvec(x[:, :2], x[:, :2], torch.ones(2), precision)(v),
                                   matvec.rbf_gram_matvec_plain(x[:, :2], x[:, :2], v, precision=precision))
    with pytest.raises(ValueError, match="precision"):  # K6 has no 'vpu', as the JAX kernel has none
        matvec.make_rbf_matvec(x[:, :2], x[:, :2], torch.ones(2), "vpu")
    with pytest.raises(ValueError, match="CUDA"):
        matvec.rbf_gram_matvec_cuda(x[:, :2], x[:, :2], torch.randn(16, 2))


def test_rbf_matvec_ops_count():
    """The bound chip_smoke.py reports rests on this count, the element as
    the kernel computes it: at d = 2, 5 FP32-lane operations (two
    differences, a square and an FMA counted as 2; the ex2 runs on the SFU),
    else per dim 3 and then 2 (the −½ product and expf); then 2R for the
    contraction."""
    assert matvec.rbf_matvec_ops(16384, 16384, 2, 9) == 16384 * 16384 * (5 + 18)
    assert matvec.rbf_matvec_ops(100, 50, 3, 4) == 100 * 50 * (3 * 3 + 2 + 8)


def test_rbf_matvec_sfu_ops_count():
    """K6's special-function-unit count, for its SFU bound: one exponential
    an element."""
    assert matvec.rbf_matvec_sfu_ops(16384, 16384) == 16384 * 16384
    assert matvec.rbf_matvec_sfu_ops(100, 50) == 5000
