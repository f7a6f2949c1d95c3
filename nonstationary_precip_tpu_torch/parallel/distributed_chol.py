"""Mesh-distributed blocked Cholesky: an N × N factorisation split over ranks.

Counterpart of ``nonstationary_precip_tpu/parallel/distributed_chol.py``.
Layout: block rows of A are split over a 1-D mesh (each rank owns an
(N/P, N) strip).  Right-looking, with left-looking reads:

  per block column j:
    1. every rank contributes its rows of column block j, and one
       ``all_gather`` assembles the (N, B) column, the only collective;
    2. every rank factors the (B, B) diagonal block itself and forms the
       panel P: L_jj on the diagonal block, and the rows below it solved
       by substitution, P_below = col_below · L_jj⁻ᵀ (O(N·B²), cheaper than
       a broadcast);
    3. each rank subtracts P_mine · Pᵀ from its strip at full width: the
       update over-subtracts only entries that are never read again
       (columns < jB live in the separate L accumulator), the trade the
       single-device streaming kernel makes with its full-height panels.

The (B, B) factor, the panel's substitution and the update are
``torch.linalg.cholesky``, ``solve_triangular`` and ``torch.matmul``, as
JAX computes them outside any Pallas kernel.  The panel departs from JAX's
(F-P8): JAX forms L_jj⁻¹ and takes the whole column, diagonal block
included, as the product col · L_jj⁻ᵀ, which is not backward stable (the
form F-P7 took out of the single-device tile); here the diagonal block is
L_jj itself and the rows below are a triangular solve.
``sharded_cholesky_2d`` is the SUMMA variant on a 2-D mesh, each rank
owning an (N/R, N/C) tile; ``sharded_mvn_logpdf`` composes the 1-D factor
with a triangular solve of the gathered factor.
"""

from __future__ import annotations

import math

import torch

from nonstationary_precip_tpu_torch.parallel.collectives import all_gather, psum
from nonstationary_precip_tpu_torch.parallel.mesh import Mesh


def _panel(col_full: torch.Tensor, jb: int, block: int) -> torch.Tensor:
    """The panel of block column j: zero above the diagonal block (those
    rows hold stale, over-subtracted entries), L_jj = chol(D) on it, and
    the rows below it solved by substitution, col_below · L_jj⁻ᵀ.  The
    strict upper triangle of the diagonal block is zero, as JAX's keep
    mask leaves it."""
    l_jj = torch.linalg.cholesky(col_full[jb:jb + block])
    below = torch.linalg.solve_triangular(l_jj, col_full[jb + block:].mT, upper=False).mT
    return torch.cat([torch.zeros_like(col_full[:jb]), l_jj, below])


def sharded_cholesky(mesh: Mesh, block: int = 256):
    """Build ``chol(a_strip) -> l_strip``: this rank's (N/P, N) strip of
    the lower factor of the PSD A from its (N/P, N) strip of A.  N must be
    divisible by P·block."""
    ndev = mesh.size

    def chol(a_strip: torch.Tensor) -> torch.Tensor:
        rows_per, n = a_strip.shape
        if n % (ndev * block) or rows_per * ndev != n:
            raise ValueError(f"N={n} must be divisible by ndev*block={ndev * block} "
                             f"(each rank's strip (N/ndev, N), got {tuple(a_strip.shape)})")
        r0 = mesh.rank * rows_per
        a_s, l_s = a_strip.clone(), torch.zeros_like(a_strip)
        for jb in range(0, n, block):
            col_full = all_gather(a_s[:, jb:jb + block], mesh)  # (N, B)
            p_full = _panel(col_full, jb, block)
            p_mine = p_full[r0:r0 + rows_per]
            l_s[:, jb:jb + block] = p_mine
            a_s = a_s - p_mine @ p_full.mT
        return l_s

    return chol


def sharded_cholesky_2d(mesh: Mesh, block: int = 256):
    """Build ``chol(a_tile) -> l_tile`` on a 2-D mesh: this rank's
    (N/R, N/C) tile of the lower factor from its tile of A (``mesh.tile``).

    Against the 1-D row layout, each rank's trailing update is
    (N/R × N/C) instead of (N/R × N), so update work and resident memory
    scale 1/(R·C).  Per block column the collectives are one (N/R, B)
    ``psum`` over the column axis (the owning column group's slice) and one
    ``all_gather`` over the row axis (the (N, B) panel).  N must be
    divisible by R·block and C·block, so that each block column lives in
    one column group."""
    row_axis, col_axis = mesh.axis
    nrow, ncol = mesh.shape[row_axis], mesh.shape[col_axis]
    ri, ci = mesh.coords[row_axis], mesh.coords[col_axis]

    def chol(a_tile: torch.Tensor) -> torch.Tensor:
        rows_per, cols_per = a_tile.shape
        n = rows_per * nrow
        if n % (nrow * block) or n % (ncol * block) or cols_per * ncol != n:
            raise ValueError(f"N={n} must be divisible by R*block={nrow * block} and C*block={ncol * block} "
                             f"(each rank's tile (N/R, N/C), got {tuple(a_tile.shape)})")
        row0, col0 = ri * rows_per, ci * cols_per
        a_t, l_t = a_tile.clone(), torch.zeros_like(a_tile)
        for jb in range(0, n, block):
            owner = jb // cols_per  # the column group holding block column j
            off = min(max(jb - col0, 0), cols_per - block)
            piece = a_t[:, off:off + block] if ci == owner else torch.zeros_like(a_t[:, :block])
            col_full = all_gather(psum(piece, mesh, col_axis), mesh, row_axis)  # (N, B)
            p_full = _panel(col_full, jb, block)
            p_rows = p_full[row0:row0 + rows_per]
            a_t = a_t - p_rows @ p_full[col0:col0 + cols_per].mT
            if ci == owner:
                l_t[:, off:off + block] = p_rows
        return l_t

    return chol


def sharded_mvn_logpdf(mesh: Mesh, block: int = 256):
    """``logpdf(a_strip, y)`` = −½(yᵀA⁻¹y + log det A + N log 2π) with A
    row-split over the mesh: the 1-D sharded factor, gathered once for the
    triangular solve (O(N²), small beside the O(N³) factorisation); y is
    held whole by every rank, and so is the value."""
    chol = sharded_cholesky(mesh, block=block)

    def logpdf(a_strip: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        l = all_gather(chol(a_strip), mesh)
        alpha = torch.linalg.solve_triangular(l, y[:, None], upper=False)[:, 0]
        logdet = 2.0 * torch.sum(torch.log(torch.diagonal(l)))
        return -0.5 * (alpha @ alpha + logdet + y.shape[-1] * math.log(2.0 * math.pi))

    return logpdf
