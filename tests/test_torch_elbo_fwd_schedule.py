"""K7's forward partition (csrc/elbo_fused.cu, elbo_fwd and its ten
launches), replayed in float64 and held to the plain forward.

There is no card here, so the kernels cannot run; this file replays how the
forward cuts the work and in which order it adds the pieces, and holds the
value, h₁ and h₂ to ``elbo_fused.reference_fwd`` (the JAX package's
``_reference_fwd``) to 1e-12 of each one's largest entry.  The partition,
one layer a phase:
  * the marginals of a layer's groups at its rows (layer 1 at the B x rows,
    layer 2 and the head at the S·B sample rows, q = s·B + b): K_xz, out =
    K_xz·W, the mean out[:, 0] and the variance s² − ΣA² + Σ(A·S)² from each
    row's sums per column tile of 128, added in tile order;
  * layer 1's row kernel: the mean with the linear prior mean, and
    h₁ = m + √max(v, 1e-10)·ε₁ for every sample of the x row;
  * layer 2's: the same at each sample row, with its own ε₂;
  * the head's: each row's expected log-likelihood term, summed over row
    tiles of 64 in row order, then the tiles in order, over S·B.
"""

import re

import numpy as np
import pytest
import torch

from nonstationary_precip_tpu_torch.ops import elbo_fused

torch.set_num_threads(1)

ROW_TILE, COL_TILE = 64, 128  # kRowTile, kColTile
FLOOR = elbo_fused.VAR_FLOOR


def _random(rng, t, b, s, m, clip, init=False):
    """K7's inputs in float64 from numpy (tests/test_torch_elbo_bwd_schedule.py's
    ``_random``); ``init`` makes W the deep GP's at init, q(u) = N(0, I):
    W = L⁻ᵀ[0 | I | I] with L the Cholesky factor of s²·K_zz + 1e-6·I, so
    each variance is s² − ΣA² + ΣA², cancelling to s² in exact arithmetic."""
    w = 0.2 * rng.normal(size=(t, 5, m, 2 * m + 1))
    w[..., m + 1:] *= 0.1
    if clip:
        w[:, [0, 4], :, m + 1:] *= 60.0
    p = {"z": rng.normal(size=(t, 5, m, 2)), "ell": np.exp(0.2 * rng.normal(size=(t, 5, 2))) + 0.3,
         "s2": np.exp(0.2 * rng.normal(size=(t, 5))), "w": w}
    for k, shape in (("mw1", (2, 2)), ("mb1", (2,)), ("mw2", (2, 2)), ("mb2", (2,)), ("mbh", (1,))):
        p[k] = 0.2 * rng.normal(size=(t, *shape))
    if init:
        zs = p["z"] / p["ell"][:, :, None, :]
        d2 = ((zs[..., :, None, :] - zs[..., None, :, :]) ** 2).sum(-1)
        kzz = p["s2"][..., None, None] * np.exp(-0.5 * d2) + 1e-6 * np.eye(m)
        lt_inv = np.linalg.inv(np.linalg.cholesky(kzz)).swapaxes(-1, -2)
        p["w"] = np.concatenate([np.zeros((t, 5, m, 1)), lt_inv, lt_inv], axis=-1)
    x = rng.normal(size=(t, b, 2))
    y = np.sin(x[..., 0]) + 0.1 * rng.normal(size=(t, b))
    e1, e2 = rng.normal(size=(t, s, 2, b)), rng.normal(size=(t, s, 2, b))
    noise = 0.2 * np.exp(0.3 * rng.normal(size=t))
    f = lambda a: torch.from_numpy(np.ascontiguousarray(a))  # noqa: E731
    return f(x), f(y), f(e1), f(e2), {k: f(v) for k, v in p.items()}, f(noise)


def _marginals(h, z, ell, s2, w, m):
    """(mean without the prior mean, unclipped variance) of one group at the
    rows h, as the marginals' two kernels and ``row_var`` form them."""
    xs, zs = h / ell, z / ell
    quad = torch.clamp((xs * xs).sum(-1)[:, None] + (zs * zs).sum(-1)[None, :] - 2.0 * (xs @ zs.T), min=0.0)
    out = (s2 * torch.exp(-0.5 * quad)) @ w
    sas = torch.zeros(out.shape[0], dtype=out.dtype)
    sa = torch.zeros_like(sas)
    cols = torch.arange(out.shape[1])
    for c0 in range(0, out.shape[1], COL_TILE):
        blk, c = out[:, c0:c0 + COL_TILE] ** 2, cols[c0:c0 + COL_TILE]
        sas = sas + blk[:, (c >= 1) & (c <= m)].sum(1)
        sa = sa + blk[:, c > m].sum(1)
    return out[:, 0], (s2 - sa) + sas


def emulate_fwd(x, y, eps1, eps2, params, noise):
    """The forward phase by phase; returns (value (T,), h₁, h₂ (T, S, B, 2))."""
    t, b, _ = x.shape
    s, m = eps1.shape[1], params["z"].shape[2]
    sb = s * b
    value = torch.zeros(t, dtype=x.dtype)
    h1 = torch.zeros(t, s, b, 2, dtype=x.dtype)
    h2 = torch.zeros_like(h1)
    for tt in range(t):
        grp = [(params["z"][tt, g], params["ell"][tt, g], params["s2"][tt, g], params["w"][tt, g]) for g in range(5)]
        # layer 1 at the x rows
        for o in range(2):
            mean, var = _marginals(x[tt], *grp[o], m)
            lin = x[tt, :, 0] * params["mw1"][tt, 0, o] + x[tt, :, 1] * params["mw1"][tt, 1, o]
            mean = mean + (lin + params["mb1"][tt, o])
            h1[tt, :, :, o] = mean + torch.sqrt(torch.clamp(var, min=FLOOR)) * eps1[tt, :, o, :]
        # layer 2 at the sample rows
        hq = h1[tt].reshape(sb, 2)
        ss, bb = torch.arange(sb) // b, torch.arange(sb) % b
        for o in range(2):
            mean, var = _marginals(hq, *grp[2 + o], m)
            lin = hq[:, 0] * params["mw2"][tt, 0, o] + hq[:, 1] * params["mw2"][tt, 1, o]
            mean = mean + (lin + params["mb2"][tt, o])
            h2[tt, ss, bb, o] = mean + torch.sqrt(torch.clamp(var, min=FLOOR)) * eps2[tt, ss, o, bb]
        # the head: each row's term, row tiles of 64 in order, then the tiles
        mean, var = _marginals(h2[tt].reshape(sb, 2), *grp[4], m)
        d = y[tt, bb] - (mean + params["mbh"][tt, 0])
        terms = -0.5 * (torch.log(2.0 * torch.pi * noise[tt]) + (d * d + torch.clamp(var, min=FLOOR)) / noise[tt])
        total = torch.zeros((), dtype=x.dtype)
        for r0 in range(0, sb, ROW_TILE):
            tile = torch.zeros((), dtype=x.dtype)
            for term in terms[r0:r0 + ROW_TILE]:
                tile = tile + term
            total = total + tile
        value[tt] = total / sb
    return value, h1, h2


@pytest.mark.parametrize("shape,kind", [((2, 40, 3, 24), "init"), ((3, 37, 2, 19), "ragged"),
                                        ((2, 50, 3, 32), "clip")], ids=["init", "ragged", "clip"])
def test_the_partition_is_the_plain_forward(shape, kind):
    """Init (q(u) = N(0, I): each variance cancels to s²), ragged (B = 37,
    S = 2: one row tile at layer 1, M = 19) and clip (layer 1's variances on
    the floor at some rows): the value, h₁ and h₂ equal the plain forward's
    to 1e-12 of their largest entry."""
    rng = np.random.default_rng(sum(shape) + len(kind))
    x, y, e1, e2, params, noise = _random(rng, *shape, kind == "clip", kind == "init")
    ref, res = elbo_fused.reference_fwd(x, y, e1, e2, params, noise)
    if kind == "clip":
        _, var, _, _ = elbo_fused._marginals(x, *elbo_fused._groups(params, slice(0, 2)))
        assert 0.0 < float((var <= FLOOR).double().mean()) < 1.0
    value, h1, h2 = emulate_fwd(x, y, e1, e2, params, noise)
    t, s, b = shape[0], shape[2], shape[1]
    for name, got, want in (("value", value, ref), ("h1", h1.reshape(t, s * b, 2), res[1]),
                            ("h2", h2.reshape(t, s * b, 2), res[2])):
        scale = float(want.abs().max())
        assert float((got - want).abs().max()) / scale <= 1e-12, name


def test_the_emulated_partition_is_the_kernels():
    """The tiles are the source's, and its forward runs the marginals one
    layer a phase, each followed by its row kernel, then the tiles' sum;
    the row-tile block of the old forward is gone."""
    text = elbo_fused.SOURCE.read_text()
    assert int(re.search(r"constexpr int kRowTile = (\d+);", text).group(1)) == ROW_TILE
    assert int(re.search(r"constexpr int kColTile = (\d+);", text).group(1)) == COL_TILE
    body = text[text.index("int elbo_fwd("):text.index("int elbo_bwd(")]
    order = [body.index(f) for f in ("launch_marginals(P, 0, 2,", "elbo_fwd_layer1_kernel<<<",
                                     "launch_marginals(P, 2, 4,", "elbo_fwd_layer2_kernel<<<",
                                     "launch_marginals(P, 4, kGroups,", "elbo_fwd_head_kernel<<<",
                                     "elbo_sum_kernel<<<")]
    assert order == sorted(order)
    for gone in ("elbo_fwd_kernel", "build_k", "group_out", "take_column", "warp_transpose_sum", "Shared"):
        assert not re.search(rf"\b{gone}\b", text), gone  # the JAX body _elbo_fwd_kernel is named in the header


def test_both_passes_take_their_marginals_from_one_function():
    """The forward and the backward reach K_xz and ``out`` only through
    ``launch_marginals``, the one function that launches their kernels, so
    the two passes' per-row means and variances are the same arithmetic."""
    text = elbo_fused.SOURCE.read_text()
    helper = text[text.index("void launch_marginals("):text.index('extern "C"')]
    fwd = text[text.index("int elbo_fwd("):text.index("int elbo_bwd(")]
    bwd = text[text.index("int elbo_bwd("):text.index("int elbo_bwd_moments(")]
    for kernel in ("elbo_k_kernel<<<", "elbo_out_kernel<<<"):
        assert text.count(kernel) == helper.count(kernel) == 1, kernel
    assert fwd.count("launch_marginals(") == 3
    assert "launch_marginals(P, 0, kGroups," in bwd
