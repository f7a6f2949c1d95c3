"""The deep GP's full-covariance propagation (``SVGPLayer.joint``,
``sample_joint``, ``DeepGP.propagate(full_cov=True)`` and
``loss(full_cov=True)``) against the JAX package, in float64 on the CPU.

The JAX models and the ε the JAX package draws from its key are rebuilt as
``tests/test_torch_deepgp.py`` rebuilds them: under ``full_cov`` JAX draws
each hidden layer's ε from the same split keys as on the marginal path,
``normal(sub, (O, B))`` per sample, so the port's (S, O, B) ε per layer is
the same tensor in both modes.  Tolerances: 1e-10 for the joint's mean and
covariance and a sample's values, 1e-8 for propagate's outputs, the loss
and every gradient (a B × B Cholesky of cov + 1e-4·I per output and sample
lies between them).
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from test_torch_deepgp import jax_eps, jax_leaves, jax_model, port_model

torch.set_num_threads(1)

B, S = 13, 3


def _x(seed, n=B):
    return np.random.default_rng(seed).normal(size=(n, 2))


def test_joint_and_sample_joint_match_jax():
    """Each layer's joint (mean, cov) with its own precompute, and one
    joint sample from JAX's key, to 1e-10; the covariance symmetric."""
    jm = jax_model(41)
    pm = port_model(jm)
    x = _x(42)
    key = jax.random.PRNGKey(43)
    layers_j = list(jm.layers) + [jm.head]
    ref = jax.jit(lambda ls, xx: [(*l.joint(xx), l.sample_joint(key, xx)) for l in ls])(layers_j, jnp.asarray(x))
    with torch.no_grad():
        for (mj, cj, sj), pl in zip(ref, list(pm.layers) + [pm.head]):
            mean, cov = pl.joint(torch.from_numpy(x))
            np.testing.assert_allclose(mean.numpy(), np.asarray(mj), rtol=1e-10, atol=1e-12)
            np.testing.assert_allclose(cov.numpy(), np.asarray(cj), rtol=1e-10, atol=1e-12)
            np.testing.assert_allclose(cov.numpy(), cov.mT.numpy(), rtol=1e-12, atol=1e-14)
            eps = np.array(jax.random.normal(key, mj.shape, dtype=jnp.float64))
            got = pl.sample_joint(torch.from_numpy(x), torch.from_numpy(eps))
            assert got.shape == (B, mj.shape[0])
            np.testing.assert_allclose(got.numpy(), np.asarray(sj), rtol=1e-10, atol=1e-12)


def test_sample_joint_shares_one_factor_across_sample_axes():
    """ε with a sample axis x lacks gives each sample's draw from the one
    joint, bit for bit the draw with x repeated on that axis."""
    pm = port_model(jax_model(44))
    layer = pm.layers[0]
    x = torch.from_numpy(_x(45))
    eps = torch.from_numpy(np.random.default_rng(46).normal(size=(S, 2, B)))
    with torch.no_grad():
        shared = layer.sample_joint(x, eps)
        per = layer.sample_joint(x.expand(S, B, 2), eps)
    assert shared.shape == (S, B, 2)
    np.testing.assert_allclose(shared.numpy(), per.numpy(), rtol=1e-12, atol=1e-14)


@pytest.mark.parametrize("share_hidden,num_layers", [(False, 2), (True, 3)])
def test_propagate_full_cov_matches_jax(share_hidden, num_layers):
    """The head's per-sample marginals after joint sampling at every hidden
    layer, the first included, against JAX's ``propagate(full_cov=True)``."""
    jm = jax_model(47, share_hidden, num_layers)
    pm = port_model(jm, share_hidden)
    x = _x(48)
    key = jax.random.PRNGKey(49)
    mj, vj = jax.jit(lambda m, xx: m.propagate(key, xx, S, full_cov=True))(jm, jnp.asarray(x))
    eps = [torch.from_numpy(e) for e in jax_eps(key, S, num_layers, B)]
    with torch.no_grad():
        mp, vp = pm.propagate(torch.from_numpy(x), eps, full_cov=True)
        mm, _ = pm.propagate(torch.from_numpy(x), eps)
    np.testing.assert_allclose(mp.numpy(), np.asarray(mj), rtol=1e-8, atol=1e-10)
    np.testing.assert_allclose(vp.numpy(), np.asarray(vj), rtol=1e-8, atol=1e-10)
    assert not np.allclose(mp.numpy(), mm.numpy())  # the joint path is not the marginal one


@pytest.mark.parametrize("share_hidden,num_layers", [(False, 2), (True, 3)])
def test_loss_full_cov_and_every_gradient_match_jax(share_hidden, num_layers):
    """−ELBO under full_cov and the gradient of every leaf against JAX's;
    the fused data term is never taken, even where it is asked for."""
    jm = jax_model(50, share_hidden, num_layers)
    pm = port_model(jm, share_hidden)
    rng = np.random.default_rng(51)
    x = rng.normal(size=(B, 2))
    y = np.sin(x[:, 0]) + 0.1 * rng.normal(size=B)
    key = jax.random.PRNGKey(52)

    def jloss(m):
        return m.loss(key, jnp.asarray(x), jnp.asarray(y), num_data=40, num_samples=S, full_cov=True)

    lj, gj = jax.jit(jax.value_and_grad(jloss))(jm)
    eps = [torch.from_numpy(e) for e in jax_eps(key, S, num_layers, B)]
    lp = pm.loss(torch.from_numpy(x), torch.from_numpy(y), 40, eps, full_cov=True, fused_elbo=True)
    lp.backward()
    np.testing.assert_allclose(float(lp.detach()), float(lj), rtol=1e-8)
    grads = jax_leaves(gj)
    named = dict(pm.named_parameters())
    assert sorted(named) == sorted(grads)
    for name, g in grads.items():
        np.testing.assert_allclose(named[name].grad.numpy(), g, rtol=1e-8, atol=1e-8 * np.abs(g).max(),
                                   err_msg=name)
