"""The schedule of K11's kernel (``csrc/trsm.cu``) on the CPU, and K10c's move
onto the shared right-looking factorisation.

The CUDA kernels run only on the card (``chip_smoke.py`` holds them to
float64 there).  Here a float32 torch emulation of K11's schedule — one
step per 128-row block i, right-looking: L_ii X_i = W_i solved by blocked
forward substitution (per 32-row block, substitution multiplying by the
pivots' reciprocals, then the rows below it minus their 32-deep product
with it), then W_j −= L_ji X_i for every j > i, each product a chain of
fused multiply-adds in ascending k subtracted once, as the kernel sums
them, so the rounding grows with 128 + N/128 — is held to float64
by ``chip_smoke.py``'s K11 criterion on the Gibbs predictive's payloads:
within twice ``torch.linalg.solve_triangular``'s float32 error plus 1e-6 of
the largest entry, and its backward error within γ_{N+1}|L||X| (Higham,
Theorem 8.5).  A product with the diagonal blocks' inverses in place of the
substitution (one recursive inverse per block, as the TPU kernel's
``_tri_inv_block`` feeds its product) breaks that bound on a noisy Gibbs
Gram at init, which is why the kernel substitutes.  Both tile solves are
held to JAX's ``pallas_chol._tri_inv_block`` in float64.
"""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nonstationary_precip_tpu.ops.pallas_chol as pc
from nonstationary_precip_tpu_torch.experiments import exact_largen
from nonstationary_precip_tpu_torch.interop import gibbs_exact_from_jax
from nonstationary_precip_tpu_torch.kernels.gibbs import gibbs_gram_reference
from nonstationary_precip_tpu_torch.ops import chol_stream, cuda_build, trsm

torch.set_num_threads(1)

#: The kernel's block rows, column tile and substitution block (``csrc/trsm.cu``
#: kB, kCT, kLeaf; checked below).
BLOCK, COLS, LEAF = 128, 32, 32
GIBBS_REF = Path(__file__).resolve().parent / "fixtures" / "jax_gibbs_dense_ref.npz"


def _fma(a, b, c):
    """c + a·b rounded once to c's type (exact products of float32 in
    float64, then one rounding), as the kernel's fmaf."""
    return (c.double() + a.double() * b.double()).to(c.dtype)


def _chain(a, b):
    """a·b summed as the kernel sums each entry's products: one chain of
    fused multiply-adds over k in ascending order."""
    acc = torch.zeros((a.shape[0], b.shape[1]), dtype=a.dtype)
    for t in range(a.shape[1]):
        acc = _fma(a[:, t:t + 1], b[t:t + 1], acc)
    return acc


def tile_solve(lii, w):
    """X = L_ii⁻¹W for a 128 × 128 lower tile as a CTA solves it: per
    32-row block, substitution (each row multiplied by its pivot's
    reciprocal, then subtracted from the rows below it in the block), then
    the rows below the block minus their 32-deep product with it."""
    rinv = 1 / torch.diagonal(lii)
    x = w.clone()
    for r0 in range(0, lii.shape[0], LEAF):
        r1 = r0 + LEAF
        for q in range(r0, r1):
            x[q] = x[q] * rinv[q]
            x[q + 1:r1] = _fma(-lii[q + 1:r1, q:q + 1], x[q:q + 1], x[q + 1:r1])
        x[r1:] = x[r1:] - _chain(lii[r1:, r0:r1], x[r0:r1])
    return x


def _leaf_inverse(l):
    """L⁻¹ of a 32 × 32 lower leaf by forward substitution of the identity."""
    x = torch.eye(l.shape[0], dtype=l.dtype)
    for k in range(l.shape[0]):
        x[k] = x[k] / l[k, k]
        x[k + 1:] = _fma(-l[k + 1:, k:k + 1], x[k:k + 1], x[k + 1:])
    return x


def tri_inv_rec(l):
    """L⁻¹ by recursive 2 × 2 blocking down to 32-wide leaves:
    I11 = rec(L11), I22 = rec(L22), I21 = −I22·(L21·I11)."""
    s = l.shape[0]
    if s == LEAF:
        return _leaf_inverse(l)
    h = s // 2
    i11, i22 = tri_inv_rec(l[:h, :h]), tri_inv_rec(l[h:, h:])
    out = torch.zeros_like(l)
    out[:h, :h], out[h:, h:] = i11, i22
    out[h:, :h] = -_chain(i22, _chain(l[h:, :h], i11))
    return out


def _inverse_product(lii, w):
    """The rejected tile solve: X = L_ii⁻¹·W with the recursive inverse."""
    return _chain(tri_inv_rec(lii), w)


def k11_emulated(l, b, tile=tile_solve):
    """X = L⁻¹B on K11's schedule: L identity-padded to a multiple of 128, B
    zero-padded to a multiple of 32 columns and copied into W; per block row
    i, X_i = ``tile``(L_ii, W_i), then W_j −= L_ji·X_i (a 128-deep sum) for
    every j > i."""
    n, k = b.shape
    lp = chol_stream.padded(l, BLOCK)
    n_pad, k_pad = lp.shape[-1], -(-k // COLS) * COLS
    w = torch.zeros((n_pad, k_pad), dtype=b.dtype)
    w[:n, :k] = b
    x = torch.empty_like(w)
    for i0 in range(0, n_pad, BLOCK):
        i1 = i0 + BLOCK
        x[i0:i1] = tile(lp[i0:i1, i0:i1], w[i0:i1])
        if i1 < n_pad:
            w[i1:] = w[i1:] - _chain(lp[i1:, i0:i1], x[i0:i1])
    return x[:n, :k]


def _predictive_case(model, x, ell):
    """(L, K_xsᵀ) of the Gibbs predictive: the factor of the noisy train
    Gram and the grid's cross-covariance, as ``GibbsExactGP.posterior``
    hands them to ``tri_solve``."""
    xq = exact_largen.gibbs_grid()
    with torch.no_grad():
        s2, noise = model.outputscale, model.likelihood.noise
        l = torch.linalg.cholesky(s2 * gibbs_gram_reference(x, ell, x, ell) + noise * torch.eye(len(x)))
        ellq = model.prior.conditional_mean(xq, (x, ell))
        return l, (s2 * gibbs_gram_reference(xq, ellq, x, ell)).mT.contiguous()


def _pinned_trained():
    """The pinned dense Gibbs run (N = 1024) at its trained pose."""
    ref = np.load(GIBBS_REF)
    model = gibbs_exact_from_jax({k[len("init."):]: ref[k] for k in ref.files if k.startswith("init.")}, "cpu")
    with torch.no_grad():
        model.log_ell.copy_(torch.tensor(ref["log_ell"]))
    return _predictive_case(model, torch.tensor(ref["x"]), torch.exp(torch.tensor(ref["log_ell"])))


def _init(n):
    """bench_scaling.py's Gibbs row of size n at its init pose."""
    x, _ = exact_largen.gibbs_data((n,))[n]
    model, _ = exact_largen.gibbs_model(x)
    return _predictive_case(model, x, torch.exp(model.log_ell.detach()))


def _trained_70():
    l, _ = _pinned_trained()
    return l, torch.tensor(np.random.default_rng(53).normal(size=(l.shape[0], 70)), dtype=torch.float32)


def _ragged_1000():
    return _init(1000)


def _random_1280():
    """A random SPD matrix's factor and 256 random columns: its error grows
    with the length of each entry's serial chain of fused multiply-adds,
    which the partial sums of 128 keep short."""
    rng = np.random.default_rng(17)
    a = rng.normal(size=(1280, 1280))
    l = np.linalg.cholesky(a @ a.T / 1280 + 0.05 * np.eye(1280))
    return torch.tensor(l, dtype=torch.float32), torch.tensor(rng.normal(size=(1280, 256)), dtype=torch.float32)


def _errors(l, b, x):
    """(error from float64 relative to its largest entry, backward-error
    ratio |L·X − B| / (γ_{N+1}|L||X| + (N + 1)·2⁻¹⁴⁹), largest entrywise)."""
    l64, b64, x64 = l.double(), b.double(), x.double()
    ref = torch.linalg.solve_triangular(l64, b64, upper=False)
    n = l.shape[0]
    gamma = (n + 1) * 2.0**-24 / (1 - (n + 1) * 2.0**-24)
    ratio = (l64 @ x64 - b64).abs() / (gamma * (l64.abs() @ x64.abs()) + (n + 1) * 2.0**-149)
    return float((x64 - ref).abs().max() / ref.abs().max()), float(ratio.max())


@pytest.mark.parametrize("payload", [_pinned_trained, _trained_70, _ragged_1000, _random_1280],
                         ids=["gibbs_trained_256", "gibbs_trained_70", "ragged_1000", "random_1280"])
def test_emulated_solve_meets_the_float64_criterion(payload):
    l, b = payload()
    assert l.dtype == b.dtype == torch.float32
    x = k11_emulated(l, b)
    assert x.shape == b.shape and bool(torch.isfinite(x).all())
    err, ratio = _errors(l, b, x)
    err_lib, ratio_lib = _errors(l, b, torch.linalg.solve_triangular(l, b, upper=False))
    assert err <= 2 * err_lib + 1e-6, (err, err_lib)
    assert ratio <= 1.0 and ratio_lib <= 1.0, (ratio, ratio_lib)


def test_inverse_product_breaks_the_backward_bound():
    """On the noisy Gibbs Grams at init (N = 1024 and 1280, the grid's 256
    columns) the product with the recursive inverses leaves a residual
    above γ_{N+1}|L||X| on one of them (ratio 1.38 at N = 1024 here, 0.41
    at 1280), where substitution and the library stay far inside it
    (0.018 and 0.011; the library 0.030 and 0.029): a product with an
    inverse is not backward stable."""
    ratios = {"inverse": [], "substitution": [], "library": []}
    for n in (1024, 1280):
        l, b = _init(n)
        for name, x in (("inverse", k11_emulated(l, b, _inverse_product)), ("substitution", k11_emulated(l, b)),
                        ("library", torch.linalg.solve_triangular(l, b, upper=False))):
            ratios[name].append(_errors(l, b, x)[1])
    assert max(ratios["inverse"]) > 1.0 > 0.1 > max(ratios["substitution"] + ratios["library"]), ratios


@pytest.mark.parametrize("tile", [tile_solve, _inverse_product], ids=["substitution", "recursive_inverse"])
def test_tile_solve_matches_jax_tri_inv_block_float64(tile):
    """A 128 tile and 40 columns in float64: the kernel's substitution (and
    the rejected recursive inverse) against JAX's ``_tri_inv_block(L)·W``,
    to 1e-12 of the largest entry: all three are exact to float64
    rounding."""
    rng = np.random.default_rng(11)
    a = rng.normal(size=(BLOCK, BLOCK))
    l = np.linalg.cholesky(a @ a.T / BLOCK + 0.1 * np.eye(BLOCK))
    w = rng.normal(size=(BLOCK, 40))
    ref = np.asarray(pc._tri_inv_block(jnp.asarray(l))) @ w
    got = tile(torch.tensor(l), torch.tensor(w)).numpy()
    assert got.dtype == np.float64
    assert np.abs(got - ref).max() <= 1e-12 * np.abs(ref).max()


def test_emulated_solve_spreads_nan_from_a_nan_pivot():
    """A NaN pivot in the first block row makes X NaN from its row on, in
    that block and in every later one (the updates carry it), and leaves
    the rows above it finite."""
    n, p = 3 * BLOCK, 50
    rng = np.random.default_rng(3)
    a = rng.normal(size=(n, n))
    l = torch.tensor(np.linalg.cholesky(a @ a.T / n + np.eye(n)), dtype=torch.float32)
    l[p, p] = float("nan")
    x = k11_emulated(l, torch.tensor(rng.normal(size=(n, 40)), dtype=torch.float32))
    assert bool(torch.isfinite(x[:p]).all()) and bool(torch.isnan(x[p:]).all())


def test_tile_widths_are_the_kernels():
    """The emulation's block, column tile and substitution block are the
    kernel's, and the wrapper pads to them."""
    text = (cuda_build.CSRC / "trsm.cu").read_text()
    consts = {name: int(re.search(rf"constexpr int {name} = (\d+);", text).group(1))
              for name in ("kB", "kCT", "kLeaf")}
    assert consts == {"kB": BLOCK, "kCT": COLS, "kLeaf": LEAF}
    assert (trsm.BLOCK, trsm.COLS) == (BLOCK, COLS)


def test_k10c_runs_the_shared_right_looking_factorisation():
    """K10c's source defines no kernel of its own: it runs
    ``csrc/chol_rl.cuh``'s factorisation (K5's, held to float64 in
    ``tests/test_torch_chol_rl.py``) and reports its kernels' attributes
    in the order that ``chol_stream.KERNELS`` names them."""
    text = (cuda_build.CSRC / "chol_stream_v1.cu").read_text()
    assert '#include "chol_rl.cuh"' in text and "blocked_chol" not in text
    assert "__global__" not in text
    look_ahead = re.search(r"constexpr bool kLookAhead = (true|false);", text).group(1)
    assert "chol_rl::factor<kLookAhead>" in text and "chol_rl::attributes<kLookAhead>" in text
    assert len(chol_stream.KERNELS) == (4 if look_ahead == "true" else 3)
    assert chol_stream.PANEL % BLOCK == 0
