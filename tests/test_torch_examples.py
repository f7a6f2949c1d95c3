"""Smoke-run the port's ported quickstarts at tests/test_examples.py's tiny
budgets, on the CPU: each runs its own asserts and prints "ok", as the JAX
examples do.  Their models are held to JAX in the module tests
(``test_torch_dense_cg.py``, ``test_torch_full_cov.py``, the exact, Gibbs
and deep GP files, ``test_torch_parallel.py`` and
``test_torch_sharded_cg.py``); chip_smoke.py runs them at their defaults on
the card.  The two parallel quickstarts run on 2 spawned gloo ranks
(``--device cpu --world 2``), the sharded one at N = 256 in both its
forms.  The two plotting demos are held to the JAX demos' numbers in
float64 on JAX's own draws, and draw nothing, saying so, without
matplotlib.
"""

import builtins

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nonstationary_precip_tpu.models import MultivariateGibbsGP as JaxMultivariateGibbsGP
from nonstationary_precip_tpu.ops.linalg import safe_cholesky as jax_safe_cholesky
from nonstationary_precip_tpu.priors.matrix_normal import MatrixNormalPrior as JaxMatrixNormalPrior
from nonstationary_precip_tpu.priors.matrix_normal import latent_rbf_row_cov as jax_latent_rbf_row_cov

from nonstationary_precip_tpu_torch.examples import (
    matrix_normal_demo,
    mv_gibbs_demo,
    quickstart_cg_largen,
    quickstart_dataparallel,
    quickstart_deepgp,
    quickstart_exact_gp,
    quickstart_gibbs_spatial,
    quickstart_lazy_largen,
    quickstart_sharded_largen,
)

torch.set_num_threads(1)

CASES = {
    "exact_gp": lambda: quickstart_exact_gp.main(num_steps=20, dev="cpu"),
    "gibbs_spatial": lambda: quickstart_gibbs_spatial.main(max_iters=5, dev="cpu"),
    "deepgp": lambda: quickstart_deepgp.main(num_epochs=2, dev="cpu"),
    "cg_largen": lambda: quickstart_cg_largen.main(n=300, num_steps=4, dev="cpu"),
    "lazy_largen": lambda: quickstart_lazy_largen.main(n=240, num_steps=4, block=60, dev="cpu"),
    "dataparallel": lambda: quickstart_dataparallel.main(world=2, dev="cpu", n=64, steps=3),
    "sharded_largen": lambda: quickstart_sharded_largen.main(world=2, dev="cpu", n=256, num_steps=5),
    "sharded_largen_gibbs": lambda: quickstart_sharded_largen.main(world=2, dev="cpu", n=256, num_steps=5,
                                                                   gibbs=True),
}


@pytest.mark.parametrize("name", list(CASES))
def test_quickstart(name, capsys):
    CASES[name]()
    assert "ok" in capsys.readouterr().out.splitlines()


@pytest.mark.parametrize("name", list(CASES))
def test_quickstart_runs_on_the_card_by_default(name):
    """Without a device argument each quickstart asks for the card, and
    raises where there is none."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    main = {"exact_gp": quickstart_exact_gp, "gibbs_spatial": quickstart_gibbs_spatial, "deepgp": quickstart_deepgp,
            "cg_largen": quickstart_cg_largen, "lazy_largen": quickstart_lazy_largen,
            "dataparallel": quickstart_dataparallel, "sharded_largen": quickstart_sharded_largen,
            "sharded_largen_gibbs": quickstart_sharded_largen}[name].main
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        main()


def _jax_grid(lo, hi):
    g = np.linspace(lo, hi, 30)
    gx, gy = np.meshgrid(g, g)
    return jnp.asarray(np.stack([gx.ravel(), gy.ravel()], axis=1), jnp.float64)


def test_mv_gibbs_demo_matches_jax():
    """The Gram and the GP sample against the JAX demo's in float64, on the
    draws its keys make (H₀'s and D₀'s from PRNGKey(173), the sample's from
    PRNGKey(1)).  H₀ = L_U Z L_Vᵀ with U the prior's RBF(0.2) row
    covariance on the 30 × 30 grid of [2, 3]² plus 1e-5 jitter, cond(U) ≈
    1e7: LAPACK's and XLA's factors of U part by ε·cond ≈ 2e-9, so the
    Gram (entries ≤ 1) is held to 1e-8 and the sample to 1e-7 of its
    largest entry."""
    x = _jax_grid(2, 3)
    n = x.shape[0]
    model = JaxMultivariateGibbsGP.create(jax.random.PRNGKey(173), x, noise=0.01, dtype=jnp.float64)
    k = model.gram(x, model.h)
    normals = jax.random.normal(jax.random.PRNGKey(1), (n,), jnp.float64)
    f = jax_safe_cholesky(k + 1e-4 * jnp.eye(n, dtype=jnp.float64)) @ normals
    k_h, k_d = jax.random.split(jax.random.PRNGKey(173))
    draws = tuple(np.array(a) for a in (jax.random.normal(k_h, (n, 2), jnp.float64),
                                        jax.random.normal(k_d, (2,), jnp.float64), normals))
    out = mv_gibbs_demo.run("cpu", torch.float64, draws)
    np.testing.assert_allclose(out["gram"].numpy(), np.asarray(k), rtol=0, atol=1e-8)
    np.testing.assert_allclose(out["f"].numpy(), np.asarray(f), rtol=0, atol=1e-7 * np.abs(np.asarray(f)).max())


def test_matrix_normal_demo_matches_jax():
    """The draw H and its log-density against the JAX demo's in float64, on
    the draw PRNGKey(173) makes."""
    x = _jax_grid(-2, 2)
    prior = JaxMatrixNormalPrior(jnp.zeros((x.shape[0], 2), jnp.float64), jax_latent_rbf_row_cov(x, [0.5, 0.5]),
                                 jnp.eye(2, dtype=jnp.float64))
    h = prior.sample(jax.random.PRNGKey(173))
    z = np.array(jax.random.normal(jax.random.PRNGKey(173), (x.shape[0], 2), jnp.float64))
    out = matrix_normal_demo.run("cpu", torch.float64, z)
    np.testing.assert_allclose(out["h"].numpy(), np.asarray(h), rtol=0, atol=1e-10 * np.abs(np.asarray(h)).max())
    np.testing.assert_allclose(float(out["log_prob"]), float(prior.log_prob(h)), rtol=1e-10)


@pytest.mark.parametrize("demo", [mv_gibbs_demo, matrix_normal_demo], ids=["mv_gibbs", "matrix_normal"])
def test_demos_draw_their_figure_or_say_they_do_not(demo, tmp_path, monkeypatch, capsys):
    """With matplotlib the demo writes its PNG; without it (the card's
    machine) it prints its numbers, says once that no figure is drawn, and
    ends with "ok"."""
    name = demo.__name__.rsplit(".", 1)[1]
    demo.main(tmp_path, dev="cpu")
    assert (tmp_path / f"{name}.png").stat().st_size > 0
    real_import = builtins.__import__

    def no_matplotlib(mod, *a, **k):
        if mod == "matplotlib" or mod.startswith("matplotlib."):
            raise ImportError("No module named 'matplotlib'")
        return real_import(mod, *a, **k)

    monkeypatch.setattr(builtins, "__import__", no_matplotlib)
    capsys.readouterr()
    demo.main(tmp_path / "none", dev="cpu")
    lines = capsys.readouterr().out.splitlines()
    assert sum("is not drawn" in line for line in lines) == 1 and lines[-1] == "ok"
    assert not (tmp_path / "none").exists()
