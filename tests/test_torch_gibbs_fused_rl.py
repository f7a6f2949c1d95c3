"""K8's schedule (csrc/gibbs_fused.cu on csrc/chol_rl.cuh) replayed in
float32 on the CPU.

There is no card here, so the kernel cannot run; ``chip_smoke.py`` holds it
to float64 on the card.  The replay follows the kernel's steps in torch:
each attempt builds the lower 128-blocks of s²K + (σ² + extra)I into the
padded L (the diagonal s² + (σ² + extra) in closed form, the padded rows
and columns the identity); then per block column the diagonal tile by
``chol_inv_rec`` (``test_torch_chol_rl.py``'s emulation of the header's
recursion), NaN whole if it fails, which sets the failure flag; α_j
forward-substituted against L_jj column by column, one division and one
fused multiply-add a row a step (``rhs_solve``); the panel X = W·L_jj⁻ᵀ by
``panel_solve``, then α_rows −= X·α_j as four partial sums a row over the
columns p, p + 4, … added as (s₀ + s₁) + (s₂ + s₃) (``panel_kernel``); and
the trailing update.  An attempt holds if no tile failed and α is finite;
the extra jitter is 0, 1e-4, then 1e-2.

Checks: the replay against the JAX kernel in interpret mode (N = 256 and a
ragged 300, ``tests/test_torch_gibbs_fused.py``'s band); against float64 by
``chip_smoke.py``'s criteria (the backward-error ratio of
``chol_bound_ratio`` ≤ 1, and L and α within twice the plain version's
error plus ``K8_FLOOR``); the ladder landing on attempt 2 on
``test_torch_gibbs_fused.py``'s singular payload; and that a non-finite
entry planted anywhere in the lower triangle of the built matrix, or in y,
sets the failure flag, which is what lets the kernel drop its sweep over
all n² entries of L.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

import nonstationary_precip_tpu.ops.pallas_fused as pf
from chip_smoke import K8_FLOOR, chol_bound_ratio
from test_torch_chol_rl import TILE, chol_inv_rec, panel_solve
from nonstationary_precip_tpu_torch.kernels.gibbs import gibbs_gram_reference
from nonstationary_precip_tpu_torch.ops import gibbs_fused
from nonstationary_precip_tpu_torch.ops.cuda_build import CSRC

torch.set_num_threads(1)

S2, NOISE = 0.644, 0.011


def _payload(n, d, seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, d))
    ell = np.exp(0.3 * rng.normal(size=(n, d))) + 0.2
    y = rng.normal(size=n)
    return tuple(a.astype(np.float32) for a in (x, ell, y))


def _fma(a, b, c):
    """fmaf: the exact product and sum, rounded once to float32."""
    return (a.double() * b.double() + c.double()).float()


def build(x, ell, y, s2, noise, extra, n_pad):
    """The build kernel: the padded s²K + (σ² + extra)I, lower 128-blocks
    (the upper triangle is never read), and α = y zero-padded."""
    n = x.shape[0]
    w = torch.eye(n_pad)
    k = s2 * gibbs_gram_reference(x, ell, x, ell)
    k.diagonal().fill_(s2 + (noise + extra))
    w[:n, :n] = k
    a = torch.zeros(n_pad)
    a[:n] = y
    return w, a


def rhs_solve(ljj, a):
    """α_j = L_jj⁻¹α_j as the tile's warp 0 does: step k divides row k by
    the pivot and takes L[i, k]·x_k off every row i > k in one FMA."""
    v = a.clone()
    for k in range(v.shape[0]):
        v[k] = v[k] / ljj[k, k]
        v[k + 1:] = _fma(-ljj[k + 1:, k], v[k].expand(v.shape[0] - k - 1), v[k + 1:])
    return v


def panel_rhs(x, aj, ar):
    """α_rows − X·α_j as the panel kernel forms it."""
    s = []
    for p in range(4):
        acc = torch.zeros(x.shape[0])
        for c in range(p, x.shape[1], 4):
            acc = _fma(x[:, c], aj[c].expand(x.shape[0]), acc)
        s.append(acc)
    return ar - ((s[0] + s[1]) + (s[2] + s[3]))


def attempt(w, a):
    """One attempt's factorisation in place on (w, a): (L, α, failed)."""
    failed = False
    for jp in range(0, w.shape[0], TILE):
        t = slice(jp, jp + TILE)
        ljj, linv = chol_inv_rec(torch.tril(w[t, t]).clone())
        ok = bool(torch.isfinite(ljj).all() and torch.isfinite(linv).all() and (torch.diagonal(ljj) > 0).all())
        if not ok:
            ljj = torch.full_like(ljj, float("nan"))
            failed = True
        w[t, t] = ljj
        a[t] = rhs_solve(ljj, a[t]) if ok else float("nan")
        below = slice(jp + TILE, None)
        p = panel_solve(w[below, t], ljj)
        w[below, t] = p
        a[below] = panel_rhs(p, a[t], a[below])
        w[below, below] -= p @ p.T
    return torch.tril(w), a, failed or not bool(torch.isfinite(a).all())


def replay(x, ell, y, s2=S2, noise=NOISE, plant=None):
    """(L, α, state): the ladder of three attempts, state 1 + the attempt
    that held, 0 if none did.  ``plant(w, a)`` edits the built matrix and
    right-hand side of every attempt before it is factored."""
    x, ell, y = (torch.as_tensor(v) for v in (x, ell, y))
    n = x.shape[0]
    n_pad = -(-n // TILE) * TILE
    for i, extra in enumerate(gibbs_fused.EXTRA_JITTER):
        w, a = build(x, ell, y, s2, noise, extra, n_pad)
        if plant is not None:
            plant(w, a)
        l, alpha, failed = attempt(w, a)
        if not failed:
            return l[:n, :n], alpha[:n], i + 1
    return l[:n, :n], alpha[:n], 0


@pytest.mark.parametrize("n", [256, 300])
def test_replay_matches_jax_fused_kernel_in_interpret_mode(n):
    x, ell, y = _payload(n, 2, seed=n)
    with pltpu.force_tpu_interpret_mode():
        chol_j, alpha_j = pf._forward(*(jnp.asarray(a) for a in (x, ell, y)), jnp.float32(S2), jnp.float32(NOISE))
    chol, alpha, state = replay(x, ell, y)
    assert state == 1 and chol.dtype == torch.float32
    np.testing.assert_allclose(chol.numpy(), np.asarray(chol_j), rtol=3e-4, atol=3e-5)
    np.testing.assert_allclose(alpha.numpy(), np.asarray(alpha_j), rtol=3e-3, atol=5e-3)
    np.testing.assert_array_equal(np.triu(chol.numpy(), 1), 0.0)


@pytest.mark.parametrize("n,d,seed", [(300, 2, 3), (200, 3, 4)])
def test_replay_meets_the_float64_criteria(n, d, seed):
    """chip_smoke.py's k8 criteria: L's backward error within
    γ_(N+1)|L||Lᵀ| of the float64 matrix, and L and α within twice the
    plain version's error from float64 plus K8_FLOOR."""
    x, ell, y = (torch.tensor(a) for a in _payload(n, d, seed))
    chol, alpha, state = replay(x, ell, y)
    assert state == 1
    a64 = S2 * gibbs_gram_reference(x.double(), ell.double(), x.double(), ell.double()) \
        + NOISE * torch.eye(n, dtype=torch.float64)
    l64 = torch.linalg.cholesky(a64)
    al64 = torch.linalg.solve_triangular(l64, y.double()[:, None], upper=False)[:, 0]
    assert chol_bound_ratio(chol, a64) <= 1.0
    lp, ap, _ = gibbs_fused.gibbs_chol_solve_plain(x, ell, y, torch.tensor(S2), torch.tensor(NOISE))
    for got, plain, ref, floor in ((chol, lp, l64, K8_FLOOR["L"]), (alpha, ap, al64, K8_FLOOR["alpha"])):
        scale = float(ref.abs().max())
        ek, ep = float((got.double() - ref).abs().max()) / scale, float((plain.double() - ref).abs().max()) / scale
        assert ek <= 2 * ep + floor, (ek, ep)


def test_ladder_lands_on_attempt_two():
    """test_torch_gibbs_fused.py's singular payload (a duplicated row at
    noise 0): the first attempt's tile fails, the second (extra jitter
    1e-4) holds, as the plain version's ladder does."""
    x, ell, y = _payload(256, 2, seed=400)
    x[100], ell[100] = x[50], ell[50]
    chol, alpha, state = replay(x, ell, y, noise=0.0)
    _, _, tries = gibbs_fused.gibbs_chol_solve_plain(*(torch.tensor(a) for a in (x, ell, y)), torch.tensor(S2),
                                                     torch.tensor(0.0))
    assert state == tries == 2
    assert bool(torch.isfinite(chol).all() and torch.isfinite(alpha).all())


@pytest.mark.parametrize("where", [(10, 3), (200, 200), (290, 5), (260, 150), (131, 129), "y"],
                         ids=["first_tile", "diagonal", "first_panel", "later_panel", "inf_second_tile", "rhs"])
def test_planted_non_finite_entry_reaches_the_flag(where):
    """A NaN (an inf at (131, 129)) planted in the built matrix's lower
    triangle, or a NaN in y, fails every attempt through the diagonal
    tiles' flag or α's check, exactly when L or α would hold a non-finite
    entry: the flag decides what the n² sweep decided."""
    x, ell, y = _payload(300, 2, seed=11)

    def plant(w, a):
        if where == "y":
            a[299] = float("nan")
        else:
            w[where] = float("inf") if where == (131, 129) else float("nan")

    x, ell, y = (torch.tensor(v) for v in (x, ell, y))
    n_pad = -(-300 // TILE) * TILE
    w, a = build(x, ell, y, S2, NOISE, 0.0, n_pad)
    plant(w, a)
    l, alpha, failed = attempt(w, a)
    swept = not bool(torch.isfinite(l).all() and torch.isfinite(alpha).all())
    assert failed and swept
    assert replay(x, ell, y, plant=plant)[2] == 0


def test_source_factors_through_chol_rl():
    """The kernel builds into L and factors it with chol_rl.cuh's schedule
    with K8's hooks: no workspace, no left-looking header, no sweep over
    L; the header the emulation replays has the hooks."""
    text = (CSRC / "gibbs_fused.cu").read_text()
    assert '#include "chol_rl.cuh"' in text and "chol_rl::factor<false, true>" in text
    assert "blocked_chol" not in text and "finite_kernel" not in text and "cbuf" not in text
    assert not (CSRC / "blocked_chol.cuh").exists()
    header = (CSRC / "chol_rl.cuh").read_text()
    for hook in ("rhs_solve(D, rhs.alpha, ok)", "rhs.state[1] = 1", "rhs.alpha[kT + blockIdx.x * kPanelRows + r]"):
        assert hook in header, hook
    assert gibbs_fused.BLOCK == TILE
