"""K7 in the PyTorch port (nonstationary_precip_tpu_torch/ops/elbo_fused.py)
against the JAX package's ``ops/pallas_elbo.py``.

Here there is no card, so the port's ``fused_data_term`` takes its plain
version (the tensors lie on the CPU); the JAX side runs its plain
``_reference_fwd``/``_reference_bwd`` or, under
``pltpu.force_tpu_interpret_mode``, its Pallas kernels.  The CUDA kernels
are held against the same plain version, in float64, by chip_smoke.py.

The port batches members on a leading axis where the JAX functions take one
model, so each member here is checked against its own JAX call.
Tolerances: in float64 the port and JAX are the same arithmetic in another
order, so values to rtol 1e-10 and every cotangent to 1e-10 of its largest
entry (against JAX's hand-derived backward and against torch.autograd of
the port's forward).  In float32 the port's plain version and JAX's Pallas
kernel sum in other orders through a chain of exps: the value to rtol 1e-5,
every cotangent to 1e-3 of its largest entry (measured at B 24, M 16,
S 2 over three seeds: the value within 2.1e-7, the cotangents within
2.2e-6).
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from nonstationary_precip_tpu.ops import pallas_elbo
from nonstationary_precip_tpu_torch import interop
from nonstationary_precip_tpu_torch.ops import elbo_fused as ef

torch.set_num_threads(1)

_jax_fwd = jax.jit(pallas_elbo._reference_fwd)
_jax_bwd = jax.jit(pallas_elbo._reference_bwd)

JAX_KEYS = ("z1", "ell1", "s21", "w1", "mw1", "mb1", "z2", "ell2", "s22", "w2", "mw2", "mb2",
            "zh", "ellh", "s2h", "wh", "mbh")


def jax_inputs(rng, b, m, s, clip=False):
    """One model's inputs in the JAX layout (numpy f64): random z, hypers,
    W and mean weights.  The A-block of W (columns M+1..2M) is scaled so
    that no variance is clipped, or (``clip``) so that some of layer 1's
    and the head's are and others are not."""
    def group(o, d):
        w = rng.normal(size=(o, m, 2 * m + 1)) * 0.2
        w[..., m + 1:] *= 0.1
        return (rng.normal(size=(o, m, d)), np.exp(rng.normal(size=(o, d)) * 0.2) + 0.3,
                np.exp(rng.normal(size=o) * 0.2), w)

    p = {}
    for sfx, o in (("1", 2), ("2", 2), ("h", 1)):
        p["z" + sfx], p["ell" + sfx], p["s2" + sfx], p["w" + sfx] = group(o, 2)
    if clip:
        p["w1"][0, :, m + 1:] *= 60.0
        p["wh"][0, :, m + 1:] *= 60.0
    p.update(mw1=rng.normal(size=(2, 2)) * 0.2, mb1=rng.normal(size=2) * 0.2, mw2=rng.normal(size=(2, 2)) * 0.2,
             mb2=rng.normal(size=2) * 0.2, mbh=rng.normal(size=1) * 0.2)
    x = rng.normal(size=(b, 2))
    y = np.sin(x[:, 0]) + 0.1 * rng.normal(size=b)
    return x, y, rng.normal(size=(s, 2, b)), rng.normal(size=(s, 2, b)), p, np.exp(rng.normal() * 0.3) * 0.2


def stacked(members, dtype=torch.float64):
    """The port's inputs for a list of ``jax_inputs`` members."""
    x = torch.tensor(np.stack([mem[0] for mem in members]), dtype=dtype)
    y = torch.tensor(np.stack([mem[1] for mem in members]), dtype=dtype)
    e1 = torch.tensor(np.stack([mem[2] for mem in members]), dtype=dtype)
    e2 = torch.tensor(np.stack([mem[3] for mem in members]), dtype=dtype)
    params = interop.elbo_params_from_jax({k: np.stack([mem[4][k] for mem in members]) for k in JAX_KEYS},
                                          torch.device("cpu"), dtype)
    noise = torch.tensor([mem[5] for mem in members], dtype=dtype)
    return x, y, e1, e2, params, noise


def jnp_args(mem, dtype=jnp.float64):
    x, y, e1, e2, p, noise = mem
    return (jnp.asarray(x, dtype), jnp.asarray(y, dtype), jnp.asarray(e1, dtype), jnp.asarray(e2, dtype),
            {k: jnp.asarray(v, dtype) for k, v in p.items()}, jnp.asarray(noise, dtype))


def as_port_bars(bars_list, noisebars, ybars):
    """JAX cotangents of several members in the port's layout (numpy)."""
    port = interop.elbo_params_from_jax({k: np.stack([np.asarray(b[k]) for b in bars_list]) for k in JAX_KEYS},
                                        torch.device("cpu"), torch.float64)
    return ({k: v.numpy() for k, v in port.items()}, np.array([float(n) for n in noisebars]),
            np.stack([np.asarray(yb) for yb in ybars]))


def close_to_largest(a, b, tol, name):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    err = np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)
    assert err <= tol, f"{name}: {err:.3g} of the largest entry > {tol}"
    return err


def members(seed, t=3, b=13, m=12, s=3, clip=False):
    rng = np.random.default_rng(seed)
    return [jax_inputs(rng, b, m, s, clip) for _ in range(t)]


def test_plain_forward_matches_jax_reference_per_member():
    """Value, h₁ and h₂ of every member against its own JAX call (f64)."""
    mems = members(0)
    x, y, e1, e2, params, noise = stacked(mems)
    dt, (_, h1, h2, _, _) = ef.reference_fwd(x, y, e1, e2, params, noise)
    t, b, s = 3, 13, 3
    for i, mem in enumerate(mems):
        dj, (_, _, h1j, h2j, _, _) = _jax_fwd(*jnp_args(mem))
        np.testing.assert_allclose(float(dt[i]), float(dj), rtol=1e-10)
        np.testing.assert_allclose(h1.reshape(t, s, b, 2)[i].numpy(), np.asarray(h1j), rtol=1e-10, atol=1e-12)
        np.testing.assert_allclose(h2.reshape(t, s, b, 2)[i].numpy(), np.asarray(h2j), rtol=1e-10, atol=1e-12)


@pytest.mark.parametrize("clip", [False, True])
def test_plain_backward_matches_jax_reference_and_autograd(clip):
    """Every cotangent of the hand-derived backward against JAX's
    ``_reference_bwd`` per member and against torch.autograd of the port's
    forward, f64, with a different gbar per member; ``clip`` puts some of
    layer 1's and the head's variances on the 1e-10 floor."""
    mems = members(1, clip=clip)
    x, y, e1, e2, params, noise = stacked(mems)
    if clip:
        _, v, _, _ = ef._marginals(x, *ef._groups(params, slice(0, 2)))
        assert bool((v <= ef.VAR_FLOOR).any()) and bool((v > ef.VAR_FLOOR).any())
    gbar = torch.tensor([1.0, -0.7, 2.3], dtype=torch.float64)
    dt, res = ef.reference_fwd(x, y, e1, e2, params, noise)
    bars, noisebar, ybar = ef.reference_bwd(x, y, e1, e2, params, noise, res, gbar)

    ref = [_jax_bwd(*jnp_args(mem), _jax_fwd(*jnp_args(mem))[1], float(g)) for mem, g in zip(mems, gbar)]
    jbars, jnoise, jy = as_port_bars([r[0] for r in ref], [r[1] for r in ref], [r[2] for r in ref])
    for k in ef.PARAM_KEYS:
        close_to_largest(bars[k].numpy(), jbars[k], 1e-10, k)
    close_to_largest(noisebar.numpy(), jnoise, 1e-10, "noise")
    close_to_largest(ybar.numpy(), jy, 1e-10, "y")

    leaves = {k: v.clone().requires_grad_(True) for k, v in params.items()}
    yy, nn = y.clone().requires_grad_(True), noise.clone().requires_grad_(True)
    out = ef.reference_fwd(x, yy, e1, e2, leaves, nn)[0]
    grads = torch.autograd.grad(out, [*leaves.values(), nn, yy], gbar)
    for k, g in zip(ef.PARAM_KEYS, grads):
        close_to_largest(bars[k].numpy(), g.numpy(), 1e-10, k)
    close_to_largest(noisebar.numpy(), grads[-2].numpy(), 1e-10, "noise")
    close_to_largest(ybar.numpy(), grads[-1].numpy(), 1e-10, "y")


def test_autograd_function_on_cpu_is_the_plain_version():
    """``fused_data_term`` on CPU tensors: the plain forward's value, the
    hand-derived backward's gradients, and no kernel launch."""
    x, y, e1, e2, params, noise = stacked(members(2, t=2))
    leaves = {k: v.clone().requires_grad_(True) for k, v in params.items()}
    nn = noise.clone().requires_grad_(True)
    before = dict(ef.LAUNCHES)
    dt = ef.fused_data_term(x, y, e1, e2, leaves, nn)
    dt.sum().backward()
    assert ef.LAUNCHES == before
    ref, res = ef.reference_fwd(x, y, e1, e2, params, noise)
    bars, nb, _ = ef.reference_bwd(x, y, e1, e2, params, noise, res, torch.ones(2, dtype=torch.float64))
    torch.testing.assert_close(dt.detach(), ref, rtol=0, atol=0)
    for k in ef.PARAM_KEYS:
        torch.testing.assert_close(leaves[k].grad, bars[k], rtol=0, atol=0)
    torch.testing.assert_close(nn.grad, nb, rtol=0, atol=0)


def test_plain_f32_matches_jax_pallas_kernel_in_interpret_mode():
    """The port's f32 plain version against the JAX Pallas K7 (forward and
    backward) run in interpret mode on one model at B 24, M 16, S 2."""
    mem = members(3, t=1, b=24, m=16, s=2)[0]
    x, y, e1, e2, p, noise = jnp_args(mem, jnp.float32)

    def f(yy, pp, nn):
        return pallas_elbo.fused_data_term(x, yy, e1, e2, pp, nn, True)

    with pltpu.force_tpu_interpret_mode():
        dj, vjp = jax.vjp(f, y, p, noise)
        yb_j, bars_j, nb_j = vjp(jnp.ones((), jnp.float32))
    xt, yt, e1t, e2t, params, nt = stacked([mem], torch.float32)
    dt, res = ef.reference_fwd(xt, yt, e1t, e2t, params, nt)
    bars, nb, yb = ef.reference_bwd(xt, yt, e1t, e2t, params, nt, res, torch.ones(1))
    np.testing.assert_allclose(float(dt[0]), float(dj), rtol=1e-5)
    jbars, jnoise, jy = as_port_bars([bars_j], [nb_j], [yb_j])
    for k in ef.PARAM_KEYS:
        close_to_largest(bars[k].numpy(), jbars[k], 1e-3, k)
    close_to_largest(nb.numpy(), jnoise, 1e-3, "noise")
    close_to_largest(yb.numpy(), jy, 1e-3, "y")


def test_gate():
    """``ineligible`` admits the TPU kernel's topology and refuses the rest."""
    x = torch.zeros(315, 2)
    z1, z2, zh = (2, 250, 2), (2, 250, 2), (1, 250, 2)
    assert ef.eligible(x, z1, z2, zh)
    assert ef.eligible(torch.zeros(10, 1024, 2), (10, *z1), (10, *z2), (10, *zh))
    assert not ef.eligible(x.double(), z1, z2, zh)
    assert ef.ineligible(x.double(), z1, z2, zh, any_float=True) is None
    assert not ef.eligible(torch.zeros(1025, 2), z1, z2, zh)
    assert not ef.eligible(x, (2, 257, 2), (2, 257, 2), (1, 257, 2))
    assert not ef.eligible(torch.zeros(315, 3), (2, 250, 3), z2, zh)
    assert not ef.eligible(x, z1, (3, 250, 2), zh)
    assert not ef.eligible(x, z1, z2, (1, 200, 2))


def _kernel_args(t=2, b=8, s=3, m=16):
    params = {"z": torch.zeros(t, 5, m, 2), "ell": torch.ones(t, 5, 2), "s2": torch.ones(t, 5),
              "w": torch.zeros(t, 5, m, 2 * m + 1), "mw1": torch.zeros(t, 2, 2), "mb1": torch.zeros(t, 2),
              "mw2": torch.zeros(t, 2, 2), "mb2": torch.zeros(t, 2), "mbh": torch.zeros(t, 1)}
    return [torch.zeros(t, b, 2), torch.zeros(t, b), torch.zeros(t, s, 2, b), torch.zeros(t, s, 2, b), params,
            torch.ones(t)]


def _with_param(a, key, value):
    a[4] = {**a[4], key: value}
    return a


@pytest.mark.parametrize(
    "change,exc",
    [
        (lambda a: [a[0].double(), *a[1:]], TypeError),
        (lambda a: _with_param(a, "w", a[4]["w"].double()), TypeError),
        (lambda a: [a[0].mT.contiguous().mT, *a[1:]], ValueError),  # not contiguous
        (lambda a: _kernel_args(m=257), ValueError),  # M > 256
        (lambda a: _kernel_args(b=1025), ValueError),  # B > 1024
        (lambda a: _with_param(a, "w", torch.zeros(2, 5, 16, 32)), ValueError),  # P != 2M + 1
        (lambda a: [a[0], a[1], a[2][:, :2], *a[3:]], ValueError),  # S differs
        (lambda a: a, ValueError),  # CPU tensors
    ],
)
def test_kernel_wrappers_reject_what_they_do_not_take(change, exc):
    """Both wrappers check dtype, contiguity, shape and device before any
    CUDA call and raise; there is no fallback."""
    args = change(_kernel_args())
    with pytest.raises(exc):
        ef.elbo_fwd_cuda(*args)
    h = torch.zeros(2, 3, 8, 2)
    with pytest.raises(exc):
        ef.elbo_bwd_cuda(*args, h, h, torch.ones(2))
