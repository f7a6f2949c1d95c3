"""``experiments/exact_largen.gibbs_dense`` (bench_scaling.py's Gibbs MAP
rows and their predictive) against the JAX package's ``GibbsExactGP``
composition, and the loss's dispatch.

The JAX run is made here, on the CPU: the same data, the same init (carried
into the port by ``interop.gibbs_exact_from_jax``), the field trained alone
by Adam at lr 0.01; on the CPU both losses take the composed Gram →
Cholesky → solve path.  In float64 the losses, the trained field and the
predictive mean and variance agree to 1e-8 (five Adam steps amplify
rounding, as in ``tests/test_torch_gibbs_slice.py``).
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import torch

from nonstationary_precip_tpu.models import GibbsExactGP as JaxGibbsExactGP
from nonstationary_precip_tpu.priors import LogNormalProcess as JaxLogNormalProcess
from nonstationary_precip_tpu.train.metrics import nlpd_joint as jax_nlpd_joint
from nonstationary_precip_tpu.train.metrics import rmse_raw as jax_rmse_raw
from nonstationary_precip_tpu.train.optim import fit as jax_fit
from nonstationary_precip_tpu_torch.experiments import exact_largen
from nonstationary_precip_tpu_torch.models.gibbs_gp import noisy_gibbs_gram
from nonstationary_precip_tpu_torch.ops import gibbs_fused
from nonstationary_precip_tpu_torch.ops.linalg import diag_part, safe_cholesky, tri_solve
from nonstationary_precip_tpu_torch.train.vmapped import stack_modules

torch.set_num_threads(1)


def jax_leaves(tree) -> dict:
    flat = jax.tree_util.tree_flatten_with_path(tree)[0]
    return {".".join(str(getattr(k, "name", k)) for k in path): np.asarray(leaf) for path, leaf in flat}


def _jax_run(x, steps):
    """bench_scaling.py's Gibbs row in JAX (float64), the field trained
    alone: (init model, losses, trained model, predictive at the grid)."""
    x = jnp.asarray(x)
    y = jnp.sin(x[:, 0])
    prior = JaxLogNormalProcess.create(2, mean=float(np.log(0.3)), outputscale=1.0, lengthscale=1.3,
                                       dtype=jnp.float64)
    model = JaxGibbsExactGP.create(x, prior, noise=0.011, outputscale=0.644, dtype=jnp.float64)
    pc = prior.gram_chol(x)
    res = jax_fit(model, lambda m, xx, yy: m.loss(xx, yy, pc), x, y, lr=0.01, num_steps=steps, mask=model.trainable())
    xq = jnp.asarray(exact_largen.gibbs_grid(torch.float64).numpy())
    return model, np.asarray(res.losses), res.model, res.model.predictive(x, y, xq), jnp.sin(xq[:, 0])


def test_gibbs_dense_matches_jax_in_float64():
    n, steps = 128, 5
    x = exact_largen.gibbs_data((n,), torch.float64)[n][0].numpy()
    jm, losses_j, trained_j, pred_j, yq = _jax_run(x, steps)
    out = exact_largen.gibbs_dense(ns=(n,), steps=steps, dev="cpu", dtype=torch.float64,
                                   init=jax_leaves(jm))[n]
    np.testing.assert_allclose(out["losses"], losses_j, rtol=1e-8)
    np.testing.assert_allclose(out["model"].log_ell.detach().numpy(), np.asarray(trained_j.log_ell),
                               rtol=1e-8, atol=1e-10)
    np.testing.assert_allclose(out["mean"].numpy(), np.asarray(pred_j.mean), rtol=1e-8, atol=1e-10)
    np.testing.assert_allclose(out["var"].numpy(), np.asarray(jnp.diagonal(pred_j.cov)), rtol=1e-8, atol=1e-12)
    np.testing.assert_allclose(out["rmse"], float(jax_rmse_raw(pred_j.mean, yq)), rtol=1e-8)
    np.testing.assert_allclose(out["nlpd"], float(jax_nlpd_joint(pred_j, yq, 1.0)), rtol=1e-8)
    # the created model is the JAX init: the run without ``init`` is the same
    again = exact_largen.gibbs_dense(ns=(n,), steps=steps, dev="cpu", dtype=torch.float64)[n]
    np.testing.assert_allclose(again["losses"], out["losses"], rtol=1e-12)


def test_draws_are_bench_scalings():
    """One default_rng(0): the Gibbs rows' 1024 × 2 and 1280 × 2 normals,
    then the dense rows'; y = sin x₀; another size is drawn after the Gibbs
    rows."""
    rng = np.random.default_rng(0)
    ref = [rng.normal(size=(n, 2)) for n in (1024, 1280, 1024, 2048)]
    gibbs = exact_largen.gibbs_data()
    dense = exact_largen.dense_data((1024, 2048))
    for got, want in zip((gibbs[1024], gibbs[1280], dense[1024], dense[2048]), ref):
        np.testing.assert_array_equal(got[0].numpy(), want.astype(np.float32))
        np.testing.assert_array_equal(got[1].numpy(), torch.sin(got[0][:, 0]).numpy())
    for n in (1280, 1024):  # a row's data does not depend on which rows are asked for
        np.testing.assert_array_equal(exact_largen.gibbs_data((n,))[n][0].numpy(), gibbs[n][0].numpy())
    after = np.random.default_rng(0)
    for n in (1024, 1280):
        after.normal(size=(n, 2))
    np.testing.assert_array_equal(exact_largen.gibbs_data((60,))[60][0].numpy(),
                                  after.normal(size=(60, 2)).astype(np.float32))
    grid = exact_largen.gibbs_grid()
    assert grid.shape == (256, 2) and float(grid.min()) == -2.0 and float(grid.max()) == 2.0


def _loss_by_hand(models, x, y, pc):
    """The composed MAP loss as the port computed it before K8: the Gram,
    safe_cholesky, tri_solve."""
    n = y.shape[-1]
    chol = safe_cholesky(noisy_gibbs_gram(models, x))
    alpha = tri_solve(chol, y)
    logp = -0.5 * (torch.sum(alpha * alpha, -1) + 2.0 * torch.sum(torch.log(diag_part(chol)), -1)
                   + n * math.log(2.0 * math.pi))
    return -(logp + models.prior.log_prob(x, models.log_ell, pc)) / n


def test_loss_dispatch_on_the_cpu(monkeypatch):
    """On the CPU an unbatched N = 800 float32 loss takes the composed path
    (K8's gate is closed there), and a batched model's loss is unchanged."""
    def no_fused(*a):
        raise AssertionError("K8's function reached on the CPU")

    monkeypatch.setattr(gibbs_fused, "gibbs_chol_solve_fused", no_fused)
    x, y = exact_largen.gibbs_data((800,))[800]
    model, pc = exact_largen.gibbs_model(x)
    with torch.no_grad():
        model.log_ell.add_(0.1 * torch.tensor(np.random.default_rng(8).normal(size=(800, 2)), dtype=torch.float32))
    torch.testing.assert_close(model.loss(x, y, pc), _loss_by_hand(model, x, y, pc), rtol=0, atol=0)
    x60, _ = exact_largen.gibbs_data((60,))[60]
    xs = torch.stack([x60, -x60])
    ys = torch.sin(xs[..., 0])
    small = [exact_largen.gibbs_model(xx) for xx in xs]
    stacked = stack_modules([m for m, _ in small])
    pcs = torch.stack([p for _, p in small])
    torch.testing.assert_close(stacked.loss(xs, ys, pcs), _loss_by_hand(stacked, xs, ys, pcs), rtol=0, atol=0)


def test_unbatched_loss_reaches_k8_inside_its_gate(monkeypatch):
    """With the gate open (as on the card) an unbatched loss goes through
    K8's function (here its plain version), and agrees with the composed
    loss; its gradient flows to the field through K8's backward."""
    x, y = exact_largen.gibbs_data((300,), torch.float64)[300]
    model, pc = exact_largen.gibbs_model(x)
    ref = model.loss(x, y, pc)
    (g_ref,) = torch.autograd.grad(ref, [model.log_ell])
    calls = []
    real = gibbs_fused.gibbs_chol_solve_fused
    monkeypatch.setattr(gibbs_fused, "eligible", lambda a, b: True)
    monkeypatch.setattr(gibbs_fused, "gibbs_chol_solve_fused", lambda *a: calls.append(1) or real(*a))
    got = model.loss(x, y, pc)
    (g,) = torch.autograd.grad(got, [model.log_ell])
    assert calls == [1]
    torch.testing.assert_close(got, ref, rtol=1e-12, atol=0)
    torch.testing.assert_close(g, g_ref, rtol=1e-9, atol=1e-12)


def test_cli_runs_the_gibbs_rows(capsys):
    out = exact_largen.main(["gibbs", "--steps", "2", "--device", "cpu"])
    assert sorted(out) == [1024, 1280]
    for n, o in out.items():
        assert o["losses"].shape == (2,) and np.isfinite(o["losses"]).all()
        assert o["mean"].shape == (256,) and np.isfinite(o["rmse"]) and np.isfinite(o["nlpd"])
    assert "exact_largen gibbs" in capsys.readouterr().out
