"""The PyTorch port's DSVI deep GP against the JAX package, in float64 on the
CPU at small M, and the experiment as a whole.

JAX models are created with an explicit dtype (conftest turns x64 on) and
carried into the port through ``interop.deepgp_from_jax``.  The port takes
its DSVI noise from the caller, so the tests rebuild the ε that the JAX loss
draws from its key: ``split(key, S)``, then per hidden layer
``k, sub = split(k)`` and ``normal(sub, (O, B))``.  On the CPU the JAX
package factors K_zz with ``safe_cholesky`` and the port with K4's plain
version; in f64 at these sizes neither takes jitter, so both are the same
math in another order.  Tolerances: rtol 1e-10 for values, 1e-8 for the
loss and every gradient and for a few Adam steps, which amplify rounding.
"""

from pathlib import Path

import numpy as np
import pandas as pd
import pytest
import torch
import jax
import jax.numpy as jnp

from nonstationary_precip_tpu.data import dataprep as jax_dataprep
from nonstationary_precip_tpu.experiments import deepgp_spatial as jax_exp
from nonstationary_precip_tpu.models.deep_gp import DeepGP as JaxDeepGP
from nonstationary_precip_tpu.train.config import ExperimentConfig as JaxConfig
from nonstationary_precip_tpu.train.optim import _epoch_schedule as jax_epoch_schedule
from nonstationary_precip_tpu.train.optim import fit_minibatched_splits as jax_fit_minibatched_splits
from nonstationary_precip_tpu.utils.config import DATASET_DIR

from nonstationary_precip_tpu_torch import interop
from nonstationary_precip_tpu_torch.data import dataprep
from nonstationary_precip_tpu_torch.experiments import deepgp_spatial
from nonstationary_precip_tpu_torch.train.optim import _epoch_schedule, fit_minibatched, fit_minibatched_splits
from nonstationary_precip_tpu_torch.models.deep_gp import DeepGP
from nonstationary_precip_tpu_torch.train.vmapped import stack_modules, unstack_module

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
FIXTURE = REPO / "tests" / "fixtures" / "jax_deepgp_ref.npz"
CPU = torch.device("cpu")
M = 16


def jax_leaves(tree) -> dict:
    """A JAX pytree as {dotted path: numpy array}, the form ``interop``
    takes (``layers.0.z``, ``head.var_chol``, ...)."""
    flat = jax.tree_util.tree_flatten_with_path(tree)[0]
    return {".".join(str(getattr(k, "name", getattr(k, "idx", k))) for k in path): np.asarray(leaf)
            for path, leaf in flat}


def jax_model(seed, share_hidden=False, num_layers=2, m=M):
    """A JAX DeepGP in f64 with every leaf moved off its init (random q(u),
    hypers, mean weights, and an upper triangle in var_chol that must not
    matter), so values and gradients are not trivially zero."""
    model = JaxDeepGP.create(jax.random.PRNGKey(seed), input_dims=2, num_layers=num_layers, num_inducing=m,
                             share_hidden=share_hidden, dtype=jnp.float64)
    rng = np.random.default_rng(seed)
    flat, tree = jax.tree_util.tree_flatten(model)
    out = []
    for leaf in flat:
        a = np.asarray(leaf)
        if a.ndim == 3 and a.shape[-1] == a.shape[-2]:  # var_chol: S = I + noise
            a = a + 0.1 * rng.normal(size=a.shape)
        elif a.ndim == 3:  # z stays
            pass
        else:
            a = a + 0.3 * rng.normal(size=a.shape)
        out.append(jnp.asarray(a))
    return jax.tree_util.tree_unflatten(tree, out)


def port_model(jm, share_hidden=False):
    return interop.deepgp_from_jax(jax_leaves(jm), CPU, torch.float64, num_layers=jm.num_layers,
                                   share_hidden=share_hidden)


def jax_eps(key, num_samples, num_hidden, b, dtype=jnp.float64):
    """The ε the JAX ``DeepGP.loss``/``predict`` draws from ``key``, per
    hidden layer (S, O, B)."""
    out = [[] for _ in range(num_hidden)]
    for k in jax.random.split(key, num_samples):
        for i in range(num_hidden):
            k, sub = jax.random.split(k)
            out[i].append(np.asarray(jax.random.normal(sub, (2, b), dtype=dtype)))
    return [np.stack(e) for e in out]


def _data(rng, n):
    x = rng.normal(size=(n, 2))
    return x, np.sin(x[:, 0]) + 0.1 * rng.normal(size=n)


def test_svgp_marginals_and_kl_match_jax():
    """Each layer's marginals (with its precompute) and KL, through interop."""
    jm = jax_model(1)
    pm = port_model(jm)
    x = np.random.default_rng(2).normal(size=(11, 2))
    ref = jax.jit(lambda layers, xx: [(*l.marginals(xx), l.kl(), l.gram_zz()) for l in layers])(
        list(jm.layers) + [jm.head], jnp.asarray(x))
    with torch.no_grad():
        for (mj, vj, klj, gj), pl in zip(ref, list(pm.layers) + [pm.head]):
            mp, vp = pl.marginals(torch.from_numpy(x))
            np.testing.assert_allclose(mp.numpy(), np.asarray(mj), rtol=1e-10, atol=1e-12)
            np.testing.assert_allclose(vp.numpy(), np.asarray(vj), rtol=1e-10, atol=1e-12)
            np.testing.assert_allclose(float(pl.kl()), float(klj), rtol=1e-10)
            np.testing.assert_allclose(pl.gram_zz().numpy(), np.asarray(gj), rtol=1e-12)


@pytest.mark.parametrize("share_hidden,num_layers", [(False, 2), (True, 3)])
def test_loss_and_every_gradient_match_jax(share_hidden, num_layers):
    """−ELBO and the gradient of every leaf against JAX's, with ε rebuilt
    from JAX's key; var_chol's upper triangle gets exactly zero gradient."""
    jm = jax_model(3, share_hidden, num_layers)
    pm = port_model(jm, share_hidden)
    rng = np.random.default_rng(4)
    x, y = _data(rng, 13)
    key = jax.random.PRNGKey(5)
    s = 3

    def jloss(m):
        return m.loss(key, jnp.asarray(x), jnp.asarray(y), num_data=40, num_samples=s)

    lj, gj = jax.jit(jax.value_and_grad(jloss))(jm)
    eps = [torch.from_numpy(e) for e in jax_eps(key, s, num_layers, 13)]
    lp = pm.loss(torch.from_numpy(x), torch.from_numpy(y), 40, eps)
    lp.backward()
    np.testing.assert_allclose(float(lp.detach()), float(lj), rtol=1e-10)
    grads = jax_leaves(gj)
    named = dict(pm.named_parameters())
    assert sorted(named) == sorted(grads)
    for name, g in grads.items():
        np.testing.assert_allclose(named[name].grad.numpy(), g, rtol=1e-8, atol=1e-10 * np.abs(g).max(),
                                   err_msg=name)
        if name.endswith("var_chol"):
            upper = np.triu(np.ones(g.shape[-2:], dtype=bool), 1)
            assert (named[name].grad.numpy()[..., upper] == 0.0).all()


def test_predict_matches_jax():
    """Per-sample means and variances and the mixture (with noise)."""
    jm = jax_model(6)
    pm = port_model(jm)
    x = np.random.default_rng(7).normal(size=(9, 2))
    key = jax.random.PRNGKey(8)
    dj, mj, vj = jax.jit(lambda m, xx: m.predict(key, xx, num_samples=5))(jm, jnp.asarray(x))
    with torch.no_grad():
        dp, mp, vp = pm.predict(torch.from_numpy(x), [torch.from_numpy(e) for e in jax_eps(key, 5, 2, 9)])
    for a, b in ((mp, mj), (vp, vj), (dp.mean, dj.mean), (dp.var, dj.var)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(dp.log_prob(torch.zeros(9)).numpy(), np.asarray(dj.log_prob(jnp.zeros(9))),
                               rtol=1e-10)


def test_not_yet_ported_raises():
    pm = port_model(jax_model(9))
    x = torch.zeros(4, 2, dtype=torch.float64)
    eps = [torch.zeros(1, 2, 4, dtype=torch.float64)] * 2
    with pytest.raises(NotImplementedError, match="not yet ported"):
        pm.propagate(x, eps, full_cov=True)
    with pytest.raises(NotImplementedError, match="not yet ported"):
        pm.layers[0].joint(x)


@pytest.mark.parametrize("splits", [1, 2])
def test_fused_loss_and_every_gradient_match_jax_composed(splits):
    """The port's loss through the fused data term (K7's plain version, its
    hand-derived backward, and on into K4's plain backward) against JAX's
    composed loss: the value and every leaf's gradient to 1e-8 in f64, for
    one model and for two stacked on a split axis."""
    jms = [jax_model(30 + k) for k in range(splits)]
    rng = np.random.default_rng(31)
    data = [_data(rng, 13) for _ in range(splits)]
    keys = [jax.random.PRNGKey(32 + k) for k in range(splits)]
    s = 3

    def jloss(m, key, x, y):
        return m.loss(key, jnp.asarray(x), jnp.asarray(y), num_data=40, num_samples=s, fused_elbo=False)

    vg = jax.jit(jax.value_and_grad(jloss))
    ref = [vg(jm, key, *d) for jm, key, d in zip(jms, keys, data)]
    eps = [[torch.from_numpy(e) for e in jax_eps(key, s, 2, 13)] for key in keys]
    if splits == 1:
        pm, x, y, eps = port_model(jms[0]), torch.from_numpy(data[0][0]), torch.from_numpy(data[0][1]), eps[0]
    else:
        pm = stack_modules([port_model(jm) for jm in jms])
        x = torch.stack([torch.from_numpy(d[0]) for d in data])
        y = torch.stack([torch.from_numpy(d[1]) for d in data])
        eps = [torch.stack(e) for e in zip(*eps)]
    lp = pm.loss(x, y, 40, eps, fused_elbo=True)
    torch.sum(lp).backward()
    np.testing.assert_allclose(lp.detach().numpy(), np.squeeze([float(r[0]) for r in ref]), rtol=1e-8)
    named = dict(pm.named_parameters())
    for k, (_, gj) in enumerate(ref):
        for name, g in jax_leaves(gj).items():
            got = named[name].grad.numpy() if splits == 1 else named[name].grad.numpy()[k]
            np.testing.assert_allclose(got, g, rtol=1e-8, atol=1e-8 * np.abs(g).max(), err_msg=name)


def _spy_paths(monkeypatch):
    """Counts of the fused and the composed data term's calls."""
    from nonstationary_precip_tpu_torch.models import deep_gp

    calls = {"fused": 0, "composed": 0}
    fused, propagate = deep_gp.elbo_fused.fused_data_term, deep_gp.DeepGP.propagate

    def count(name, fn):
        def wrapped(*a, **k):
            calls[name] += 1
            return fn(*a, **k)
        return wrapped

    monkeypatch.setattr(deep_gp.elbo_fused, "fused_data_term", count("fused", fused))
    monkeypatch.setattr(deep_gp.DeepGP, "propagate", count("composed", propagate))
    return calls


@pytest.mark.parametrize(
    "case,path",
    [
        ("eligible", "fused"),
        ("f64", "composed"),
        ("share_hidden", "composed"),
        ("d3", "composed"),
        ("m257", "composed"),
        ("b1025", "composed"),
        ("forced_f64", "fused"),
        ("off", "composed"),
    ],
)
def test_fused_elbo_dispatch(case, path, monkeypatch):
    """``fused_elbo=None`` takes the fused term for an eligible f32 call and
    the composed path elsewhere (f64, tied layers, D = 3, M = 257,
    B = 1025); ``True`` takes it in f64 on the CPU; ``False`` never does."""
    calls = _spy_paths(monkeypatch)
    gen = torch.Generator().manual_seed(0)
    d, m, b = (3 if case == "d3" else 2), (257 if case == "m257" else 8), (1025 if case == "b1025" else 6)
    dtype = torch.float64 if case in ("f64", "forced_f64") else torch.float32
    model = DeepGP.create(gen, input_dims=d, num_layers=2, num_inducing=m, share_hidden=case == "share_hidden",
                          hidden_dims=d if case == "share_hidden" else 2, dtype=dtype)
    x = torch.randn(b, d, generator=gen, dtype=dtype)
    eps = [torch.randn(2, 2, b, generator=gen, dtype=dtype) for _ in range(2)]
    fused_elbo = {"forced_f64": True, "off": False}.get(case)
    with torch.no_grad():
        loss = model.loss(x, torch.zeros(b, dtype=dtype), 10, eps, fused_elbo=fused_elbo)
    assert torch.isfinite(loss)
    assert calls == {"fused": int(path == "fused"), "composed": int(path == "composed")}


@pytest.mark.parametrize("case", ["share_hidden", "d3", "m257", "b1025", "eps_shape"])
def test_fused_elbo_true_outside_the_gate_raises(case):
    """``fused_elbo=True`` raises outside the gate: it never returns to the
    composed path quietly."""
    gen = torch.Generator().manual_seed(1)
    d = 3 if case == "d3" else 2
    m, b = (257 if case == "m257" else 8), (1025 if case == "b1025" else 6)
    model = DeepGP.create(gen, input_dims=d, num_layers=2, num_inducing=m, share_hidden=case == "share_hidden",
                          hidden_dims=d if case == "share_hidden" else 2)
    x = torch.randn(b, d, generator=gen)
    eps = [torch.randn(2, 2, b, generator=gen) for _ in range(2)]
    if case == "eps_shape":  # the layers are eligible; an ε of the wrong B is refused
        eps = [eps[0], eps[1][:, :, :-1]]
    with pytest.raises(ValueError, match="fused_elbo=True"):
        model.loss(x, torch.zeros(b), 10, eps, fused_elbo=True)


@pytest.mark.parametrize("seed,n,epochs,batch", [(0, 315, 3, 315), (3, 20, 3, 8), (5, 7, 2, 10), (1, 12, 2, 4)])
def test_epoch_schedule_is_bit_identical(seed, n, epochs, batch):
    np.testing.assert_array_equal(_epoch_schedule(seed, n, epochs, batch), jax_epoch_schedule(seed, n, epochs, batch))


def test_lockstep_fit_matches_jax_and_the_sequential_port():
    """2 splits × 3 epochs of 3 minibatches in lockstep: losses and trained
    leaves against JAX's ``fit_minibatched_splits`` (ε from its per-step
    keys), then each split's sequential ``fit_minibatched`` against the
    lockstep trace."""
    n, batch, epochs, s = 20, 8, 3, 2
    rng = np.random.default_rng(10)
    data = [_data(rng, n) for _ in range(2)]
    jms = [jax_model(11 + k) for k in range(2)]
    keys = [jax.random.PRNGKey(20 + k) for k in range(2)]

    def jloss(m, kk, xb, yb):
        return m.loss(kk, xb, yb, num_data=n, num_samples=s)

    res_j = jax_fit_minibatched_splits(jms, jloss, [jnp.asarray(d[0]) for d in data],
                                       [jnp.asarray(d[1]) for d in data], keys=keys, num_epochs=epochs,
                                       batch_size=batch, lr=0.01, seeds=[0, 1])
    steps = epochs * 3
    eps = [tuple(torch.from_numpy(np.stack(e)) for e in zip(*[jax_eps(kt, s, 2, batch)
                                                             for kt in jax.random.split(keys[k], steps)]))
           for k in range(2)]

    def ploss(m, e, xb, yb):
        return m.loss(xb, yb, num_data=n, eps=e)

    xs = [torch.from_numpy(d[0]) for d in data]
    ys = [torch.from_numpy(d[1]) for d in data]
    res_p = fit_minibatched_splits([port_model(jm) for jm in jms], ploss, xs, ys, eps, num_epochs=epochs,
                                   batch_size=batch, lr=0.01, seeds=[0, 1])
    assert res_p.losses.shape == (steps, 2)
    np.testing.assert_allclose(res_p.losses, np.asarray(res_j.losses), rtol=1e-8)
    trained = jax_leaves(res_j.model)
    for name, p in res_p.model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), trained[name], rtol=1e-8, atol=1e-10, err_msg=name)

    for k, seq_model in enumerate(unstack_module(res_p.model, 2)):
        res_s = fit_minibatched(port_model(jms[k]), ploss, xs[k], ys[k], eps[k], num_epochs=epochs,
                                batch_size=batch, lr=0.01, seed=k)
        np.testing.assert_allclose(res_s.losses, res_p.losses[:, k], rtol=1e-10)
        for (name, a), b in zip(res_s.model.named_parameters(), seq_model.parameters()):
            np.testing.assert_allclose(a.detach().numpy(), b.detach().numpy(), rtol=1e-10, atol=1e-12,
                                       err_msg=name)


def test_dataprep_and_prep_split_match_jax():
    """The CSV, whitening, Box-Cox and the sklearn-style shuffle + contiguous
    cut give the JAX package's arrays, so the same stations train."""
    data = dataprep.load_csv(DATASET_DIR / "uib_spatial.csv")
    # the JAX loader reads through pandas, or through csrc/libfastcsv.so
    # where that is built, whose strtod rounds 2 of the 1182 values one ulp
    # away from pandas' parser; the port transcribes pandas'
    np.testing.assert_array_equal(data, pd.read_csv(DATASET_DIR / "uib_spatial.csv").values)
    np.testing.assert_allclose(data, jax_dataprep.load_csv(DATASET_DIR / "uib_spatial.csv"), rtol=3e-16, atol=0)
    bc, bc_j = dataprep.box_cox_transform(data), jax_dataprep.box_cox_transform(data)
    np.testing.assert_array_equal(bc.x, bc_j.x)
    np.testing.assert_array_equal(bc.y, bc_j.y)
    cfg = deepgp_spatial.default_config()
    cfg_j = JaxConfig(model="whitening", num_inducing=M)
    for split in (0, 7):
        w, w_j = (mod.whitening_transform(mod.sklearn_style_shuffle(data, split)) for mod in (dataprep, jax_dataprep))
        assert w.stdy == w_j.stdy
        parts = dataprep.train_test_split(w.x, w.y, cfg.train_percent / 100)
        for a, b in zip(parts, jax_dataprep.train_test_split(w_j.x, w_j.y, 0.8)):
            np.testing.assert_array_equal(a, b)
        _, tensors, stdy, eps_train, eps_pred = deepgp_spatial.prep_split(data, split, cfg.parse_args(
            ["--num_inducing", str(M), "--num_epochs", "2", "--device", "cpu"]))
        _, arrays_j, stdy_j, _, _ = jax_exp.prep_split(data, split, cfg_j)
        for a, b in zip(tensors, arrays_j):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        assert float(stdy) == float(stdy_j)
        assert tensors[0].shape == (315, 2) and [e.shape for e in eps_train] == [(2, 3, 2, 315)] * 2
        assert [e.shape for e in eps_pred] == [(10, 2, 79)] * 2


def test_fixture_matches_the_ports_inputs_and_step0_loss():
    """The pinned JAX run (tools/pin_jax_deepgp.py) trains the port's
    splits on the port's schedule, and the port's f32 loss from its init
    and ε matches step 0 (rtol 1e-4, chip_smoke.py's band; both f32)."""
    ref = np.load(FIXTURE)
    cfg = deepgp_spatial.default_config().parse_args(["--num_epochs", "10", "--device", "cpu"])
    data = dataprep.load_csv(DATASET_DIR / "uib_spatial.csv")
    preps = [deepgp_spatial.prep_split(data, s, cfg) for s in ref["splits"]]
    x = np.stack([p[1][0].numpy() for p in preps]).astype(np.float64)
    y = np.stack([p[1][1].numpy() for p in preps]).astype(np.float64)
    sums = np.stack([x.sum(axis=(-1, -2)), (x * x).sum(axis=(-1, -2)), y.sum(axis=-1)], axis=-1)
    np.testing.assert_allclose(sums, ref["checksums"], rtol=1e-12)
    sched = np.stack([_epoch_schedule(int(s), 315, 10, 315) for s in ref["splits"]], axis=1)
    np.testing.assert_array_equal(sched, ref["batch_idx"])
    model = interop.deepgp_from_jax({k[5:]: ref[k] for k in ref.files if k.startswith("init.")}, CPU)
    idx = torch.from_numpy(sched[0].astype(np.int64))
    rows = torch.arange(2)[:, None]
    xb, yb = torch.from_numpy(x.astype(np.float32))[rows, idx], torch.from_numpy(y.astype(np.float32))[rows, idx]
    with torch.no_grad():
        loss = model.loss(xb, yb, 315, [torch.from_numpy(ref[f"eps_{i}"][0]) for i in range(2)])
    np.testing.assert_allclose(loss.numpy(), ref["losses"][0], rtol=1e-4)
    assert not ref["jitter_init"].any()


def test_main_cpu_smoke_and_the_sequential_oracle():
    """``main`` end to end on the CPU at a small size gives finite metrics,
    and ``run_one_split`` (one split trained alone) reproduces split 0 of
    the lockstep ``run`` (rtol 1e-4: f32, batched against unbatched
    products)."""
    argv = ["--num_splits", "2", "--num_epochs", "2", "--num_inducing", "16", "--device", "cpu"]
    rmse, nlpd = deepgp_spatial.main(argv)
    assert np.isfinite(rmse) and np.isfinite(nlpd)
    cfg = deepgp_spatial.default_config().parse_args(argv)
    out = deepgp_spatial.run(cfg)
    r, nl, res = deepgp_spatial.run_one_split(dataprep.load_csv(DATASET_DIR / "uib_spatial.csv"), 0, cfg)
    np.testing.assert_allclose([r, nl], [out["rmses"][0], out["nlpds"][0]], rtol=1e-4)
    np.testing.assert_allclose(res.losses, out["losses"][:, 0], rtol=1e-4)


def test_port_imports_no_jax():
    """No module of the port, and not chip_smoke.py, imports jax, optax or
    the JAX package (an ast scan of every import statement)."""
    import ast

    paths = sorted((REPO / "nonstationary_precip_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
    for path in paths:
        tree = ast.parse(path.read_text())
        names = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import) for a in n.names]
        names += [n.module for n in ast.walk(tree) if isinstance(n, ast.ImportFrom) and n.module]
        roots = {name.split(".")[0] for name in names}
        assert not roots & {"jax", "jaxlib", "optax", "nonstationary_precip_tpu"}, (path, roots)
