"""The blocking of K5's and K10a's kernel (``csrc/chol_rl.cuh``) on the CPU.

The CUDA kernel runs only on the card (``chip_smoke.py`` holds it to float64
there).  Here a float32 torch emulation of its blocking — right-looking at
128-wide tiles, each diagonal tile by recursive 2 × 2 blocking down to
32-wide leaves (a leaf: right-looking column steps; between leaves L21 by
forward substitution against L11), the panel by forward substitution
against L_jj in 32-column blocks — is held to float64 by ``chip_smoke.py``'s own criterion on the paths'
payloads: the factor within twice ``torch.linalg.cholesky``'s float32 error
plus 1e-6 of the largest entry, and its backward error within
γ_{N+1}|L||Lᵀ| (Higham, Theorem 10.3).  On the matrix-normal demo's
ill-conditioned 900² row covariance the backward error alone is held, and
the product with L11⁻¹ that JAX's ``pallas_chol._chol_inv_rec`` forms in
its place (the kernel's until F-P7) is shown to break it.  The recursion's
factor is held to JAX's ``_chol_inv_rec`` in float64 (to the float32
rounding of JAX's products; see that test).  A last test holds every wrapper's ctypes signature
to the ``extern "C"`` function it calls, parsed from its ``.cu`` file.
"""

import ctypes
import re
import types
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nonstationary_precip_tpu.ops.pallas_chol as pc
from nonstationary_precip_tpu_torch.experiments import exact_largen
from nonstationary_precip_tpu_torch.interop import gibbs_exact_from_jax
from nonstationary_precip_tpu_torch.kernels.gibbs import gibbs_gram_reference
from nonstationary_precip_tpu_torch.ops import (chol_blocked, chol_inv, chol_stream, cuda_build, elbo_fused,
                                                gibbs_fused, gibbs_gram, matvec, svgp_precompute, trsm)

torch.set_num_threads(1)

LEAF = 32
#: The kernel's tile width (``csrc/chol_rl.cuh`` kT; checked below).
TILE = 128
GIBBS_REF = Path(__file__).resolve().parent / "fixtures" / "jax_gibbs_dense_ref.npz"


def _leaf(d):
    """L of a 32 × 32 leaf as one warp computes it: right-looking column
    steps on the lower triangle."""
    n = d.shape[-1]
    a = torch.tril(d)
    for k in range(n):
        lkk = torch.sqrt(a[k, k])
        a[k + 1:, k] = a[k + 1:, k] / lkk
        a[k, k] = lkk
        a[k + 1:, k + 1:] -= torch.outer(a[k + 1:, k], a[k + 1:, k])
    return torch.tril(a)


def chol_rec(d):
    """L of a square tile of 32·2ᵏ: ``_chol_inv_rec``'s recursion down to
    32-wide leaves, with L21 = D21·L11⁻ᵀ by ``panel_solve`` (the kernel's
    ``lower_solve``) where JAX multiplies by L11⁻¹."""
    s = d.shape[-1]
    if s == LEAF:
        return _leaf(d)
    h = s // 2
    l11 = chol_rec(d[:h, :h])
    l21 = panel_solve(d[h:, :h], l11)
    l22 = chol_rec(d[h:, h:] - l21 @ l21.T)
    z = torch.zeros((h, h), dtype=d.dtype)
    return torch.cat([torch.cat([l11, z], 1), torch.cat([l21, l22], 1)])


def _chol_inv_rec_product(d):
    """(L, L⁻¹) by ``_chol_inv_rec``'s products with L11⁻¹, the recursion
    the kernel had until F-P7, for the test that shows its fault."""
    s = d.shape[-1]
    if s == LEAF:
        l = _leaf(d)
        return l, torch.linalg.solve_triangular(l, torch.eye(s, dtype=d.dtype), upper=False)
    h = s // 2
    l11, i11 = _chol_inv_rec_product(d[:h, :h])
    l21 = d[h:, :h] @ i11.T
    l22, i22 = _chol_inv_rec_product(d[h:, h:] - l21 @ l21.T)
    z = torch.zeros((h, h), dtype=d.dtype)
    l = torch.cat([torch.cat([l11, z], 1), torch.cat([l21, l22], 1)])
    li = torch.cat([torch.cat([i11, z], 1), torch.cat([-(i22 @ (l21 @ i11)), i22], 1)])
    return l, li


def panel_solve(w, ljj):
    """X = W·L_jj⁻ᵀ as the panel kernel computes it: per 32-column block,
    the update by the blocks already solved, then forward substitution
    against the diagonal block."""
    x = w.clone()
    for c0 in range(0, ljj.shape[-1], LEAF):
        c1 = c0 + LEAF
        r = x[:, c0:c1] - x[:, :c0] @ ljj[c0:c1, :c0].T
        x[:, c0:c1] = torch.linalg.solve_triangular(ljj[c0:c1, c0:c1], r.T, upper=False).T
    return x


def rl_cholesky(mat, tile=chol_rec):
    """The kernel's blocking in torch ops: the matrix identity-padded to a
    multiple of 128, then per block column the diagonal tile by ``tile``
    (NaN whole if a pivot is not > 0 or an entry not finite), the panel
    W·L_jj⁻ᵀ by ``panel_solve`` and the trailing update W −= P·Pᵀ."""
    n = mat.shape[-1]
    w = torch.tril(chol_stream.padded(mat, TILE))
    for jp in range(0, w.shape[-1], TILE):
        d = w[jp:jp + TILE, jp:jp + TILE]
        ljj = tile(d.clone())
        if not (bool(torch.isfinite(ljj).all()) and bool((torch.diagonal(ljj) > 0).all())):
            ljj = torch.full_like(ljj, float("nan"))
        w[jp:jp + TILE, jp:jp + TILE] = ljj
        p = panel_solve(w[jp + TILE:, jp:jp + TILE], ljj)
        w[jp + TILE:, jp:jp + TILE] = p
        w[jp + TILE:, jp + TILE:] -= p @ p.T
    return torch.tril(w)[:n, :n]


def _gibbs_gram():
    """The pinned dense Gibbs run's noisy Gram at its trained pose (N = 1024)."""
    ref = np.load(GIBBS_REF)
    init = {k[len("init."):]: ref[k] for k in ref.files if k.startswith("init.")}
    model = gibbs_exact_from_jax(init, "cpu")
    x, ell = torch.tensor(ref["x"]), torch.exp(torch.tensor(ref["log_ell"]))
    with torch.no_grad():
        return model.outputscale * gibbs_gram_reference(x, ell, x, ell) + model.likelihood.noise * torch.eye(len(x))


def _rbf_gram(n=1024):
    """The exact loop's RBF Gram at its init pose (``chip_smoke.dense_gram``)."""
    x, _ = exact_largen.dense_data((n,))[n]
    model = exact_largen.dense_model(dev="cpu")
    with torch.no_grad():
        return model.kernel(x) + model.likelihood.noise * torch.eye(n)


def _ragged_spd(n=1000):
    b = torch.randn(n, n, generator=torch.Generator().manual_seed(41), dtype=torch.float64)
    return (b @ b.T / n + torch.eye(n, dtype=torch.float64)).float()


@pytest.mark.parametrize("payload", [_gibbs_gram, _rbf_gram, _ragged_spd], ids=["gibbs_trained", "rbf_init",
                                                                               "ragged_1000"])
def test_emulated_blocking_meets_the_float64_criterion(payload):
    a = payload()
    assert a.dtype == torch.float32
    l = rl_cholesky(a)
    a64 = torch.tril(a.double()) + torch.tril(a.double(), -1).T
    l64 = torch.linalg.cholesky(a64)
    assert bool(torch.isfinite(l).all()) and torch.equal(torch.triu(l, 1), torch.zeros_like(l))
    err = float((l.double() - l64).abs().max())
    err_lib = float((torch.linalg.cholesky(a).double() - l64).abs().max())
    assert err <= 2 * err_lib + 1e-6 * float(l64.abs().max()), (err, err_lib)
    n = a.shape[-1]
    gamma = (n + 1) * 2.0**-24 / (1 - (n + 1) * 2.0**-24)
    lk = l.double()
    ratio = float(((lk @ lk.T - a64).abs() / (gamma * (lk.abs() @ lk.abs().T))).max())
    assert ratio <= 1.0, ratio


def _matrix_normal_row_cov(jitter):
    """The matrix-normal demo's 900² row covariance (RBF of lengthscale 0.5
    on a 30 × 30 grid of [−2, 2]²) with ``jitter`` on its diagonal: κ₂
    4.3e8 at the prior's 1e-5, 7.3e6 at 2e-5, the first retry of
    ``safe_cholesky``'s ladder, which K10a took on the card."""
    from nonstationary_precip_tpu_torch.examples.mv_gibbs_demo import grid
    from nonstationary_precip_tpu_torch.priors.matrix_normal import latent_rbf_row_cov

    _, _, xg = grid(-2.0, 2.0)
    u = latent_rbf_row_cov(torch.tensor(xg, dtype=torch.float32), [0.5, 0.5])
    return u + jitter * torch.eye(u.shape[0])


@pytest.mark.parametrize("jitter", [1e-5, 2e-5])
def test_emulated_blocking_is_backward_stable_on_an_ill_conditioned_tile(jitter):
    """F-P7: on the matrix-normal demo's row covariance the factor's
    backward error is within γ_{N+1}|L||Lᵀ| (here ~0.016 of it); the
    product with L11⁻¹ that the diagonal tile formed before (JAX's
    ``_chol_inv_rec``) fails the factor at 1e-5, where potrf succeeds, and
    at 2e-5 breaks the bound 60 times over (the card's K10a: 70.6)."""
    a = _matrix_normal_row_cov(jitter)
    a64 = torch.tril(a.double()) + torch.tril(a.double(), -1).T
    n = a.shape[-1]
    gamma = (n + 1) * 2.0**-24 / (1 - (n + 1) * 2.0**-24)

    def ratio(l):
        lk = l.double()
        return float(((lk @ lk.T - a64).abs() / (gamma * (lk.abs() @ lk.abs().T))).max())

    l = rl_cholesky(a)
    assert bool(torch.isfinite(l).all()) and ratio(l) <= 1.0, ratio(l)
    assert bool(torch.isfinite(torch.linalg.cholesky(a)).all())
    old = rl_cholesky(a, tile=lambda d: _chol_inv_rec_product(d)[0])
    assert not bool(torch.isfinite(old).all()) or ratio(old) > 1.0


def test_tile_widths_are_the_kernels():
    """The emulation's tile and leaf are the kernel's, and the wrappers pad
    to a multiple of the tile (K5 to the TPU kernel's 256, K10a to 128)."""
    text = (cuda_build.CSRC / "chol_rl.cuh").read_text()
    assert re.search(r"constexpr int kT = (\d+);", text).group(1) == str(TILE)
    assert re.search(r"constexpr int kLeaf = (\d+);", text).group(1) == str(LEAF)
    assert chol_blocked.BLOCK % TILE == 0 and chol_stream.PANEL % TILE == 0


def test_emulated_blocking_spreads_nan_from_a_failed_tile():
    """A rank-30 matrix fails at its first diagonal tile: every column from
    there on is NaN, as safe_cholesky's retry needs."""
    lr = torch.randn(300, 30, generator=torch.Generator().manual_seed(47), dtype=torch.float64)
    l = rl_cholesky((lr @ lr.T).float())
    lower = torch.ones(300, 300, dtype=torch.bool).tril()
    assert bool(torch.isnan(l[lower]).all()) and not bool(l[~lower].any())


def test_recursion_matches_jax_chol_inv_rec_float64():
    """On a 256 tile in float64 (two levels of 2 × 2 above JAX's 128-wide
    base, three above the kernel's 32-wide leaves).  The JAX recursion asks
    its products for float32 (``preferred_element_type``) and returns
    float32, so it agrees with the float64 factor to float32 rounding
    (3.4e-7 of the largest entry); the emulations are exact to float64
    rounding, so they agree to JAX's rounding: the kernel's recursion
    (``chol_rec``, which forms no inverse) in L, the product form it
    replaced in L and L⁻¹."""
    rng = np.random.default_rng(9)
    b = rng.normal(size=(256, 256))
    d = b @ b.T / 256 + np.eye(256)
    rl, rli = (np.asarray(t, dtype=np.float64) for t in pc._chol_inv_rec(jnp.asarray(d)))
    l, li = (t.numpy() for t in _chol_inv_rec_product(torch.tensor(d)))
    lk = chol_rec(torch.tensor(d)).numpy()
    l64 = np.linalg.cholesky(d)
    li64 = np.linalg.inv(l64)
    assert l.dtype == np.float64 and lk.dtype == np.float64
    for got, jax_, ref in ((lk, rl, l64), (l, rl, l64), (li, rli, li64)):
        scale = np.abs(ref).max()
        assert np.abs(got - ref).max() <= 1e-13 * scale
        assert np.abs(got - jax_).max() <= 1e-6 * scale
        np.testing.assert_array_equal(np.triu(got, 1), 0.0)


def _c_signatures(source):
    """{function: parameter count} of the ``extern "C"`` definitions in a
    ``.cu`` file."""
    text = source.read_text()
    out = {}
    for block in re.findall(r'extern "C" \{(.*?)\}  // extern "C"', text, flags=re.S):
        for name, params in re.findall(r"^\w[\w\s\*]*?\b(\w+)\(([^)]*)\)\s*\{", block, flags=re.M):
            out[name] = len([p for p in params.split(",") if p.strip() not in ("", "void")])
    return out


class _FakeLib:
    """Records the ctypes attributes a wrapper sets on its library."""

    def __init__(self):
        self.fns = {}

    def __getattr__(self, name):
        if name.startswith("_"):
            raise AttributeError(name)
        return self.fns.setdefault(name, types.SimpleNamespace())


BUILDS = [(chol_blocked, "build"), (chol_stream, "build"), (chol_stream, "build_v1"), (chol_inv, "build"),
          (matvec, "build"), (svgp_precompute, "build"), (elbo_fused, "build"), (gibbs_gram, "build"),
          (gibbs_fused, "build"), (trsm, "build")]


@pytest.mark.parametrize("module,build", BUILDS, ids=[f"{m.__name__.rsplit('.', 1)[1]}.{b}" for m, b in BUILDS])
def test_ctypes_argtypes_match_the_c_entry_points(monkeypatch, module, build):
    """Each wrapper passes as many arguments as its C function takes: a
    drift would pass wrong pointers on the card rather than fail here."""
    seen = {}

    def fake_build_library(source, force=False):
        seen["source"] = source
        seen["lib"] = _FakeLib()
        return seen["lib"], ""

    monkeypatch.setattr(module, "build_library", fake_build_library)
    for name in ("_lib", "_v1_lib"):
        if hasattr(module, name):
            monkeypatch.setattr(module, name, getattr(module, name))
    getattr(module, build)()
    sigs = _c_signatures(seen["source"])
    bound = {k: v for k, v in seen["lib"].fns.items() if hasattr(v, "argtypes")}
    assert bound, f"{module.__name__}.{build} set no argtypes"
    assert seen["source"].parent == cuda_build.CSRC
    for name, fn in bound.items():
        assert name in sigs, f"{name} is not an extern \"C\" function of {seen['source'].name}"
        assert len(fn.argtypes) == sigs[name], (name, len(fn.argtypes), sigs[name])
        assert all(isinstance(t, type) and issubclass(t, ctypes._SimpleCData) for t in fn.argtypes), name
