"""The cluster (L, L⁻¹) schedule of csrc/chol_inv_cluster.cuh, emulated in
torch, for the tests of the two kernels built on it: K1
(tests/test_torch_chol_inv_cluster.py) and K4
(tests/test_torch_svgp_cluster.py).

There is no card here, so the kernels cannot run; this replays their
arithmetic in the kernels' order, block step by block step, on a batch of
members at once.  The member is padded to a multiple of 32 with an
identity block and kept as 32 × 32 tiles of its lower triangle.  Block
step k: the one-warp leaf factors S_kk and inverts L_kk in one pass of 32
column steps (rsqrt, rank-1 updates); the panel L_ik = S_ik L_kk⁻ᵀ and row
k of L⁻¹, X_kj = L_kk⁻¹ W_kj, by forward substitution (dividing by L_kk's
diagonal, or multiplying by its reciprocal); then every tile
below row k takes its rank-32 update, the 32 products of each entry summed
first and applied once: W_ij − L_ik X_kj (j < k), −L_ik X_kk (j = k),
S_ij − L_ik L_jkᵀ (j > k).  A non-positive or non-finite pivot, or a
non-finite entry of the leaf, the panel or row k of L⁻¹, fails the try; a
failed try restarts the member from the Source's next rung.

What the two kernels differ in is a Source, as in the header: the matrix
of a try (``matrix``), the rounding of the substitutions, and the ladder (``tries``, ``jitter``).  In float32 every fused
multiply-add of the kernels (the leaf's rank-1 updates, the substitutions'
sums, the update's 32-term sums) is replayed as the card computes it, the
exact product and sum rounded once (through float64); rsqrt is torch's,
correctly rounded twice where the card's is an approximation, so the tests
hold the replay to the criteria the card is held to, not to the card's
bits.
"""

import torch

B = 32  # the block width (kB)


def _fma(a, b, c):
    """fmaf in float32 (the exact a·b + c, one rounding, through float64);
    in float64 a·b + c."""
    if c.dtype == torch.float32:
        return (a.double() * b.double() + c.double()).float()
    return a * b + c


def _leaf(s):
    """L_kk and L_kk⁻¹ of a stack of 32 × 32 tiles by the leaf's 32 column
    steps, and which members failed (a pivot not > 0, an entry not finite)."""
    t = s.shape[0]
    a = torch.tril(s).clone()
    x = torch.eye(B, dtype=s.dtype).expand(t, B, B).clone()
    lo = torch.zeros_like(s)
    xo = torch.zeros_like(s)
    bad = torch.zeros(t, dtype=torch.bool)
    for k in range(B):
        d = a[:, k, k]
        lcol = torch.zeros(t, B, dtype=s.dtype)
        rs = torch.rsqrt(d)
        lcol[:, k + 1:] = a[:, k + 1:, k] * rs[:, None]
        lcol[:, k] = d * rs
        xk = x[:, k] * rs[:, None]
        bad |= ~((d > 0) & torch.isfinite(lcol).all(-1) & torch.isfinite(xk).all(-1))
        lo[:, :, k] = lcol
        xo[:, k] = xk
        a[:, :, k + 1:] = _fma(-lcol[:, :, None], lcol[:, None, k + 1:], a[:, :, k + 1:])
        x[:, k + 1:] = _fma(-lcol[:, k + 1:, None], xk[:, None, :], x[:, k + 1:])
    return lo, xo, bad


def _substitute_rows(l, v, recip):
    """Each row y of v (a stack) solved from L y = v_row by forward
    substitution: dividing by L's diagonal or, ``recip``, multiplying by
    its reciprocal."""
    v = v.clone()
    rdiag = 1.0 / torch.diagonal(l, dim1=-2, dim2=-1)
    for m in range(B):
        s = torch.zeros(v.shape[:2], dtype=v.dtype)
        for p in range(m):  # the sum in ascending p, one fma a term
            s = _fma(l[:, m, p, None], v[:, :, p], s)
        v[:, :, m] = (v[:, :, m] - s) * rdiag[:, m, None] if recip else (v[:, :, m] - s) / l[:, m, m, None]
    return v


def one_try(full, recip=False):
    """(L, L⁻¹, failed) of a stack of padded members (T, 32 nb, 32 nb) by
    the block schedule; L and L⁻¹ are the padded ones."""
    nb = full.shape[-1] // B
    t = full.shape[0]
    w = {(i, j): full[:, i * B:(i + 1) * B, j * B:(j + 1) * B].clone() for i in range(nb) for j in range(i + 1)}
    lo = torch.zeros_like(full)
    xo = torch.zeros_like(full)
    bad = torch.zeros(t, dtype=torch.bool)
    for k in range(nb):
        lkk, xkk, leaf_bad = _leaf(w[k, k])
        bad |= leaf_bad
        lo[:, k * B:(k + 1) * B, k * B:(k + 1) * B] = lkk
        xo[:, k * B:(k + 1) * B, k * B:(k + 1) * B] = xkk
        for i in range(k + 1, nb):  # the panel, a row a lane
            w[i, k] = _substitute_rows(lkk, w[i, k], recip)
            bad |= ~torch.isfinite(w[i, k]).flatten(1).all(-1)
            lo[:, i * B:(i + 1) * B, k * B:(k + 1) * B] = w[i, k]
        for j in range(k):  # row k of L⁻¹, a column a lane
            w[k, j] = _substitute_rows(lkk, w[k, j].mT, recip).mT
            bad |= ~torch.isfinite(w[k, j]).flatten(1).all(-1)
            xo[:, k * B:(k + 1) * B, j * B:(j + 1) * B] = w[k, j]
        buf = {j: w[k, j] for j in range(k)}  # X_kj, natural
        buf[k] = xkk
        buf.update({i: w[i, k].mT for i in range(k + 1, nb)})  # L_ik^T
        for i in range(k + 1, nb):
            for j in range(i + 1):
                prod = torch.zeros_like(buf[j])
                for mm in range(B):  # 32 products an entry, one fma each, ascending
                    prod = _fma(buf[i][:, mm, :, None], buf[j][:, mm, None, :], prod)
                w[i, j] = -prod if j == k else w[i, j] - prod
    return lo, xo, bad


def pad(mats, n):
    """A stack of n × n members inside the identity of the next multiple of 32."""
    npad = -(-n // B) * B
    full = torch.eye(npad, dtype=mats.dtype).repeat(mats.shape[0], 1, 1)
    full[:, :n, :n] = mats
    return full


def emulate(source, t, n, dtype):
    """The kernel's (L, L⁻¹, jitter per member) of T members of size n: try
    0 on every member, then each later rung on the members that failed every
    try so far, as the kernel's clusters do each on its own.  ``source``
    gives ``tries``, ``recip`` (the header's kRecip), ``jitter(prev,
    attempt)`` (a float of ``dtype``'s precision) and ``matrix(attempt, jit,
    idx)``, the padded matrices of the members ``idx`` at that try.  A member whose every try fails is NaN."""
    npad = -(-n // B) * B
    ls = torch.full((t, npad, npad), float("nan"), dtype=dtype)
    lis = torch.full((t, npad, npad), float("nan"), dtype=dtype)
    jits = torch.zeros(t, dtype=dtype)
    todo = torch.arange(t)
    jit = 0.0
    for attempt in range(source.tries):
        jit = source.jitter(jit, attempt)
        jits[todo] = jit
        lo, xo, bad = one_try(source.matrix(attempt, jit, todo), source.recip)
        ok = todo[~bad]
        ls[ok], lis[ok] = lo[~bad], xo[~bad]
        todo = todo[bad]
        if len(todo) == 0:
            break
    return ls[:, :n, :n], lis[:, :n, :n], jits, (ls, lis)


class PaddedSource:
    """K1's Source: A + j·I, j = 0 then ``jitter``, ×10, at most
    ``max_tries`` times after the first try; the substitutions divide."""

    recip = False

    def __init__(self, mats, jitter=1e-5, max_tries=6):
        self.mats, self.base, self.tries = mats, jitter, max_tries + 1

    def jitter(self, prev, attempt):
        """In the members' precision, as the kernel's f32 ladder."""
        if attempt == 0:
            return 0.0
        prev = torch.tensor(prev, dtype=self.mats.dtype)
        return float(torch.tensor(self.base, dtype=self.mats.dtype) if prev == 0 else prev * 10.0)

    def matrix(self, attempt, jit, idx):
        n = self.mats.shape[-1]
        a = self.mats[idx] + torch.tensor(jit, dtype=self.mats.dtype) * torch.eye(n, dtype=self.mats.dtype)
        return pad(a, n)
