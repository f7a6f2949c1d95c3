"""The d = 2 Gibbs element of csrc/gibbs_elem.cuh (``d2_elem``), replayed in
float32 numpy, for the tests of the kernels that compute it: K2
(tests/test_torch_matvec_d2.py) and K9 (tests/test_torch_gibbs_gram_d2.py).

There is no card here, so the kernels cannot run.  The replay rounds every
operation to float32 as the kernels do, fused multiply-adds once (the exact
product and sum in float64, then one rounding), and takes rsqrt and exp2
correctly rounded where the card uses the special-function unit's
approximations (``rsqrt.approx``, ``ex2.approx``, ~2⁻²² each).
"""

import numpy as np

F32 = np.float32
LN2, TWO_LN2 = F32(0.693147180559945309), F32(1.386294361119890618)  # the header's kLn2, kTwoLn2


def fma(a, b, c):
    """fmaf: the exact product and sum, one rounding to float32."""
    return (np.asarray(a, np.float64) * np.asarray(b, np.float64) + np.asarray(c, np.float64)).astype(F32)


def replay_d2(x1, l1, x2, l2):
    """K(x1, x2) (N1, N2) in float32 as ``d2_elem`` forms it: the row
    factors once a row, the column factors once a column, then per element
    s_k = fma(l_ik², ln 2, q_jk), rs = rsqrt(s₀s₁), y = fma(d₁², s₀, d₀²·s₁)·rs²,
    K = ((n_i·n_j)·rs)·2⁻ʸ."""
    ai0, ai1 = l1[:, 0] * l1[:, 0], l1[:, 1] * l1[:, 1]
    ni = np.sqrt(l1[:, 0] * l1[:, 1]) * TWO_LN2
    qj0, qj1 = (l2[:, 0] * l2[:, 0]) * LN2, (l2[:, 1] * l2[:, 1]) * LN2
    nj = np.sqrt(l2[:, 0] * l2[:, 1])
    s0 = fma(ai0[:, None], LN2, qj0[None, :])
    s1 = fma(ai1[:, None], LN2, qj1[None, :])
    rs = (1.0 / np.sqrt((s0 * s1).astype(np.float64))).astype(F32)
    d0 = x1[:, 0, None] - x2[None, :, 0]
    d1 = x1[:, 1, None] - x2[None, :, 1]
    y = fma(d1 * d1, s0, (d0 * d0) * s1) * (rs * rs)
    e = np.exp2(-y.astype(np.float64)).astype(F32)
    return ((ni[:, None] * nj[None, :]) * rs) * e


def bound_ratio(k, x1, l1, x2, l2):
    """|K − K₆₄| over the element's float64 bound (24 + 24·Q)·u·K₆₄ + 2⁻¹²⁶,
    entrywise (tests/test_torch_matvec_d2.py derives it; Q = quadnum / p,
    the exponent; below f32's least normal 2⁻¹²⁶ an element underflows, and
    the card's .ftz flushes it to 0: that much more, absolute).  K is the
    float32 Gram of the payloads (x1, l1) × (x2, l2); ≤ 1 everywhere passes."""
    import torch

    from nonstationary_precip_tpu_torch.kernels.gibbs import gibbs_gram_reference

    t = [torch.from_numpy(np.asarray(a, np.float64)) for a in (x1, l1, x2, l2)]
    ref = gibbs_gram_reference(*t).numpy()
    ss0 = t[1][:, None, 0] ** 2 + t[3][None, :, 0] ** 2
    ss1 = t[1][:, None, 1] ** 2 + t[3][None, :, 1] ** 2
    d0, d1 = t[0][:, None, 0] - t[2][None, :, 0], t[0][:, None, 1] - t[2][None, :, 1]
    q = ((d0**2 * ss1 + d1**2 * ss0) / (ss0 * ss1)).numpy()
    return np.abs(np.asarray(k, np.float64) - ref) / ((24.0 + 24.0 * q) * 2.0**-24 * ref + 2.0**-126)
