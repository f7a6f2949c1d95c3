"""K7's backward partition (csrc/elbo_fused.cu, elbo_bwd and its ten
launches), replayed in float64 and held to the plain pullback.

There is no card here, so the kernels cannot run; this file replays how the
backward cuts the work and in which order it adds the pieces, and holds the
result to ``elbo_fused.reference_bwd`` (the JAX package's hand-derived
pullback) to 1e-12 of each cotangent's largest entry.  The partition:
  * scratch rows per member: B for each layer-1 group, S·B for each other
    (sample row q = s·B + b), in group order; K_xz and out of every group
    at every row;
  * each row's sums of (A·S)² and A² per column tile of 128, added in tile
    order into its variance;
  * the chain one layer a phase: the head's row cotangents; its pullback
    in tiles of 64 rows × 128 inducing points (the input cotangent per row
    and W half, the column sums of g, g·h, g·(h − z)² per row tile); layer
    2's (h2bar the head's two halves in order); its pullback; layer 1's
    (h1bar the mean weights' part, then layer 2's groups and halves in
    order, summed over each x row's samples); its pullback;
  * W̄ = K_xzᵀ·outbar over each group's rows; the small cotangents from the
    partials: z̄ from the column sums added over the row tiles in order, ℓ̄
    and s̄² over the inducing points, the rows' varbar, the mean weights,
    m̄bh and σ̄² over the rows, ȳ per x row over its samples.
"""

import re

import numpy as np
import pytest
import torch

from nonstationary_precip_tpu_torch.ops import elbo_fused

torch.set_num_threads(1)

ROW_TILE, COL_TILE = 64, 128  # kRowTile, kColTile
FLOOR = elbo_fused.VAR_FLOOR


def _random(rng, t, b, s, m, clip):
    """K7's inputs in float64 (chip_smoke.py's k7_random, from numpy)."""
    w = 0.2 * rng.normal(size=(t, 5, m, 2 * m + 1))
    w[..., m + 1:] *= 0.1
    if clip:
        w[:, [0, 4], :, m + 1:] *= 60.0
    p = {"z": rng.normal(size=(t, 5, m, 2)), "ell": np.exp(0.2 * rng.normal(size=(t, 5, 2))) + 0.3,
         "s2": np.exp(0.2 * rng.normal(size=(t, 5))), "w": w}
    for k, shape in (("mw1", (2, 2)), ("mb1", (2,)), ("mw2", (2, 2)), ("mb2", (2,)), ("mbh", (1,))):
        p[k] = 0.2 * rng.normal(size=(t, *shape))
    x = rng.normal(size=(t, b, 2))
    y = np.sin(x[..., 0]) + 0.1 * rng.normal(size=(t, b))
    e1, e2 = rng.normal(size=(t, s, 2, b)), rng.normal(size=(t, s, 2, b))
    noise = 0.2 * np.exp(0.3 * rng.normal(size=t))
    f = lambda a: torch.from_numpy(np.ascontiguousarray(a))  # noqa: E731
    return f(x), f(y), f(e1), f(e2), {k: f(v) for k, v in p.items()}, f(noise)


def _kxz(h, z, ell, s2):
    """K_xz (R, M) of rows h (R, 2) against z (M, 2), as the kernel forms it."""
    xs, zs = h / ell, z / ell
    quad = torch.clamp((xs * xs).sum(-1)[:, None] + (zs * zs).sum(-1)[None, :] - 2.0 * xs @ zs.T, min=0.0)
    return s2 * torch.exp(-0.5 * quad)


def _kxz(h, z, ell, s2):
    """K_xz (R, M) of rows h (R, 2) against z (M, 2), as the K kernel forms it."""
    xs, zs = h / ell, z / ell
    quad = torch.clamp((xs * xs).sum(-1)[:, None] + (zs * zs).sum(-1)[None, :] - 2.0 * (xs @ zs.T), min=0.0)
    return s2 * torch.exp(-0.5 * quad)


def _var(out, s2, m):
    """The unclipped variance: each row's sums of (A·S)² and A² per column
    tile, added in tile order."""
    sas = torch.zeros(out.shape[0], dtype=out.dtype)
    sa = torch.zeros_like(sas)
    cols = torch.arange(out.shape[1])
    for c0 in range(0, out.shape[1], COL_TILE):
        blk = out[:, c0:c0 + COL_TILE] ** 2
        c = cols[c0:c0 + COL_TILE]
        sas = sas + blk[:, (c >= 1) & (c <= m)].sum(1)
        sa = sa + blk[:, c > m].sum(1)
    return (s2 - sa) + sas


def _outbar(out, meanbar, varbar, m):
    return torch.cat([meanbar[:, None], 2.0 * varbar[:, None] * out[:, 1:m + 1],
                      -2.0 * varbar[:, None] * out[:, m + 1:]], dim=1)


def _pull(k, outbar, w, h, z, ell):
    """One group's pullback by tiles: per W half, each row's input
    cotangent part; per row tile, the column sums (g, g·h₀, g·h₁,
    g·(h₀ − z₀)², g·(h₁ − z₁)²) of g = kbar·K_xz."""
    g = (outbar @ w.T) * k
    il = 1.0 / (ell * ell)
    halves = []
    for m0 in range(0, 2 * COL_TILE, COL_TILE):
        gh, zh = g[:, m0:m0 + COL_TILE], z[m0:m0 + COL_TILE]
        halves.append(-(gh.sum(1)[:, None] * h - gh @ zh) * il)
    cols = []
    for r0 in range(0, g.shape[0], ROW_TILE):
        gt, ht = g[r0:r0 + ROW_TILE], h[r0:r0 + ROW_TILE]
        cols.append(torch.stack([gt.sum(0), gt.T @ ht[:, 0], gt.T @ ht[:, 1],
                                 (gt * (ht[:, 0, None] - z[None, :, 0]) ** 2).sum(0),
                                 (gt * (ht[:, 1, None] - z[None, :, 1]) ** 2).sum(0)], dim=1))
    return halves, cols


def emulate_bwd(x, y, eps1, eps2, params, noise, h1, h2, gbar):
    """The backward phase by phase; returns what ``elbo_bwd_cuda`` returns."""
    t, b, _ = x.shape
    s, m = eps1.shape[1], params["z"].shape[2]
    sb = s * b
    p = 2 * m + 1
    h1 = h1.reshape(t, sb, 2)
    h2 = h2.reshape(t, sb, 2)
    zero = torch.zeros((), dtype=x.dtype)
    bars = {k: torch.zeros_like(v) for k, v in params.items()}
    bars["w"] = torch.zeros(t, 5, m, p, dtype=x.dtype)
    noisebar = torch.zeros(t, dtype=x.dtype)
    ybar = torch.zeros(t, b, dtype=x.dtype)
    for tt in range(t):
        grp = [(params["z"][tt, g], params["ell"][tt, g], params["s2"][tt, g], params["w"][tt, g]) for g in range(5)]
        hs = [x[tt], x[tt], h1[tt], h1[tt], h2[tt]]
        ks = [_kxz(hs[g], *grp[g][:3]) for g in range(5)]
        outs = [ks[g] @ grp[g][3] for g in range(5)]
        var = [_var(outs[g], grp[g][2], m) for g in range(5)]
        n3, coef = noise[tt], gbar[tt] / sb
        # the head
        yv = y[tt, torch.arange(sb) % b]
        mh = outs[4][:, 0] + params["mbh"][tt, 0]
        diff = mh - yv
        mb_h = coef * (-diff / n3)
        vb_h = torch.where(var[4] > FLOOR, coef * (-0.5 / n3), zero)
        nb_h = coef * (-0.5 / n3 + 0.5 * ((yv - mh) ** 2 + torch.clamp(var[4], min=FLOOR)) / n3**2)
        yb_h = coef * (diff / n3)
        obar = [None] * 5
        obar[4] = _outbar(outs[4], mb_h, vb_h, m)
        cols = [None] * 5
        hb_head, cols[4] = _pull(ks[4], obar[4], grp[4][3], hs[4], grp[4][0], grp[4][1])
        # layer 2
        h2bar = hb_head[0] + hb_head[1]
        ss = torch.arange(sb) // b
        bb = torch.arange(sb) % b
        mb2, vb2 = [], []
        h1lin = torch.zeros(sb, 2, dtype=x.dtype)
        for o in range(2):
            mb = h2bar[:, o]
            vb = torch.where(var[2 + o] > FLOOR,
                             mb * eps2[tt, ss, o, bb] * 0.5 / torch.sqrt(torch.clamp(var[2 + o], min=FLOOR)), zero)
            h1lin = h1lin + mb[:, None] * params["mw2"][tt, :, o]
            mb2.append(mb)
            vb2.append(vb)
            obar[2 + o] = _outbar(outs[2 + o], mb, vb, m)
        hb_l2 = []
        for o in range(2):
            halves, cols[2 + o] = _pull(ks[2 + o], obar[2 + o], grp[2 + o][3], hs[2 + o], grp[2 + o][0], grp[2 + o][1])
            hb_l2 += halves
        # layer 1, a sample at a time into its x row
        h1bar = h1lin
        for part in hb_l2:
            h1bar = h1bar + part
        mb1, vb1 = [], []
        for o in range(2):
            sd1 = torch.sqrt(torch.clamp(var[o], min=FLOOR))
            m1 = torch.zeros(b, dtype=x.dtype)
            v1 = torch.zeros(b, dtype=x.dtype)
            for si in range(s):
                hq = h1bar[si * b:(si + 1) * b, o]
                m1 = m1 + hq
                v1 = v1 + hq * eps1[tt, si, o] * 0.5 / sd1
            mb1.append(m1)
            vb1.append(torch.where(var[o] > FLOOR, v1, zero))
            obar[o] = _outbar(outs[o], m1, vb1[o], m)
        for o in range(2):
            _, cols[o] = _pull(ks[o], obar[o], grp[o][3], hs[o], grp[o][0], grp[o][1])
        # W-bar and the small cotangents
        vbs = [vb1[0], vb1[1], vb2[0], vb2[1], vb_h]
        for g in range(5):
            z, ell, s2, _ = grp[g]
            bars["w"][tt, g] = ks[g].T @ obar[g]
            c = cols[g][0]
            for tile in cols[g][1:]:
                c = c + tile
            bars["z"][tt, g] = -(c[:, :1] * z - c[:, 1:3]) / (ell * ell)
            bars["ell"][tt, g] = c[:, 3:5].sum(0) / ell**3
            bars["s2"][tt, g] = c[:, 0].sum() / s2 + vbs[g].sum()
        bars["mw1"][tt] = torch.stack([x[tt].T @ mb1[o] for o in range(2)], dim=1)
        bars["mb1"][tt] = torch.stack([mb1[o].sum() for o in range(2)])
        bars["mw2"][tt] = torch.stack([h1[tt].T @ mb2[o] for o in range(2)], dim=1)
        bars["mb2"][tt] = torch.stack([mb2[o].sum() for o in range(2)])
        bars["mbh"][tt] = mb_h.sum()
        noisebar[tt] = nb_h.sum()
        ybar[tt] = yb_h.reshape(s, b).sum(0)
    return bars, noisebar, ybar


@pytest.mark.parametrize("shape,clip", [((3, 37, 2, 19), False), ((2, 50, 3, 32), True), ((2, 70, 3, 200), False)],
                         ids=["ragged", "clip", "two_tiles"])
def test_the_partition_is_the_plain_pullback(shape, clip):
    """Ragged (B = 37, S = 2: one row tile a group, M = 19: one W half),
    clip (layer 1's variances on the floor at some rows) and two tiles
    (S·B = 210: four row tiles; M = 200: both W halves, P = 401: four column
    tiles): every cotangent equals the plain pullback to 1e-12 of its
    largest entry."""
    rng = np.random.default_rng(sum(shape))
    x, y, e1, e2, params, noise = _random(rng, *shape, clip)
    gbar = torch.linspace(0.5, 1.5, shape[0], dtype=torch.float64)
    _, res = elbo_fused.reference_fwd(x, y, e1, e2, params, noise)
    ref, ref_nb, ref_yb = elbo_fused.reference_bwd(x, y, e1, e2, params, noise, res, gbar)
    if clip:
        _, var, _, _ = elbo_fused._marginals(x, *elbo_fused._groups(params, slice(0, 2)))
        assert 0.0 < float((var <= FLOOR).double().mean()) < 1.0
    bars, nb, yb = emulate_bwd(x, y, e1, e2, params, noise, res[1], res[2], gbar)
    for name, got, want in [*((k, bars[k], ref[k]) for k in elbo_fused.PARAM_KEYS), ("noise", nb, ref_nb),
                            ("y", yb, ref_yb)]:
        scale = max(float(want.abs().max()), 1e-300)
        assert float((got - want).abs().max()) / scale <= 1e-12, name


def test_the_emulated_partition_is_the_kernels():
    """The row and column tiles and the scratch strides are the source's."""
    text = elbo_fused.SOURCE.read_text()
    assert int(re.search(r"constexpr int kRowTile = (\d+);", text).group(1)) == ROW_TILE
    assert int(re.search(r"constexpr int kColTile = (\d+);", text).group(1)) == COL_TILE
    assert "int elbo_out_ld(int m) { return (2 * m + 1 + 3) / 4 * 4; }" in text
    assert "int elbo_k_ld(int m) { return (m + 3) / 4 * 4; }" in text
