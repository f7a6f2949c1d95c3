"""The port's batch-inference CLI (``nonstationary_precip_tpu_torch.serve``)
and its dispatcher against the JAX package's, on the CPU.

Every family (and the matrix-free path at N = 256) is served at a tiny
budget from the pinned JAX run's initial leaves and draws
(tests/fixtures/jax_serve_ref.npz, made by tools/pin_jax_serve.py, read by
``interop.serve_case_from_jax``: the same CSV, JAX's init carried by
``interop``, its deep GP ε and its matrix-free probes), in float32 on both
sides.  Held to JAX's:
  * the step-0 loss, rtol 1e-4 (the matrix-free loss 1e-3: an SLQ estimate
    over mBCG, whose float32 rounding compounds over 16 iterations; the
    sparse MV model 1e-2: cond(U) ~ 1e7 of its prior), and the last loss,
    rtol 1e-2;
  * the step-0 loss in float64, rtol 1e-10;
  * the served mean and σ at JAX's fitted pose (its leaves as a port
    checkpoint): in float32 within twice JAX's own float32 distance from
    its float64 serve, in float64 within 1e-8 of the largest value (the
    test docstrings give each exception);
  * the CSV's header and shape.
The rest of the CLI is checked on its own: the checkpoint round trip
serves the same bits, ``fit``'s lr back-off retries and halves as JAX's
does, the finite-prediction gate leaves no checkpoint, the flags that
raise do, and the large-N flags (``--chunked``, ``--precond nystrom``) serve.
"""

import contextlib
import io
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from nonstationary_precip_tpu.train.optim import fit as jax_fit
from nonstationary_precip_tpu.train.optim import fit_chunked as jax_fit_chunked

from nonstationary_precip_tpu_torch import __main__ as cli
from nonstationary_precip_tpu_torch import interop, serve
from nonstationary_precip_tpu_torch.train.checkpoint import save_pytree
from nonstationary_precip_tpu_torch.train.optim import fit

torch.set_num_threads(1)
REF = np.load(Path(__file__).resolve().parent / "fixtures" / "jax_serve_ref.npz")
FAMILIES = [c for c in REF["cases"] if not c.startswith("mf")]
MF_CASE = "mf256"
LOSS0_RTOL = {"default": 1e-4, MF_CASE: 1e-3, "mv_gibbs_sparse": 1e-2}
LAST_RTOL = {c: 1e-2 for c in FAMILIES + [MF_CASE] if c != "mv_gibbs_sparse"}


def pinned(tmp_path: Path, case: str, output: str, *extra) -> tuple:
    """(argv, init, fitted, draws) of a pinned case
    (``interop.serve_case_from_jax``), its argv served on the CPU to
    ``output`` with ``extra`` flags."""
    argv, init, fitted, draws = interop.serve_case_from_jax(REF, case, tmp_path)
    return [*argv, "--output", output, "--device", "cpu", *extra], init, fitted, draws


def serve_case(tmp_path, case, *extra):
    out_csv = tmp_path / f"{case}.out.csv"
    argv, init, _, draws = pinned(tmp_path, case, str(out_csv), *extra)
    with contextlib.redirect_stdout(io.StringIO()) as printed:
        out = serve.run(serve.config(argv), init=init, draws=draws)
    return out, out_csv, printed.getvalue()


@pytest.mark.parametrize("case", FAMILIES + [MF_CASE])
def test_fit_from_jax_init_tracks_jax(case, tmp_path):
    """The serve's fit from JAX's init and draws: step-0 loss (LOSS0_RTOL)
    and last loss (LAST_RTOL) against JAX's, no back-off, a finite hindcast
    and the CSV's header and shape as JAX's."""
    out, out_csv, printed = serve_case(tmp_path, case)
    want = REF[f"{case}.losses"]
    loss0 = float(REF[f"{case}.loss0"])
    rel0 = abs(float(out["losses"][0]) - loss0) / abs(loss0)
    assert rel0 <= LOSS0_RTOL.get(case, LOSS0_RTOL["default"]), (case, rel0)
    assert out["steps"] == len(want) and out["backoffs"] == 0 and np.isfinite(out["losses"]).all()
    if case in LAST_RTOL:
        rel = abs(float(out["losses"][-1]) - float(want[-1])) / abs(float(want[-1]))
        assert rel <= LAST_RTOL[case], (case, rel)
    assert np.isfinite(out["mean"]).all() and np.isfinite(out["std"]).all() and np.isfinite(out["hindcast_rmse"])
    csv = np.loadtxt(out_csv, delimiter=",", skiprows=1)
    assert out_csv.read_text().splitlines()[0] == str(REF[f"{case}.csv_header"])
    assert csv.shape == tuple(REF[f"{case}.csv_shape"])
    np.testing.assert_array_equal(csv[:, -2], out["mean"])
    if case.startswith("mf"):
        assert "[ok]" in printed and "alpha solve relres=" in printed


def model_of(cfg, params: dict, d: int, dtype=torch.float32):
    return interop.serve_model_from_jax(cfg.model, params, d, torch.device("cpu"), dtype, num_layers=cfg.num_layers)


@pytest.mark.parametrize("case", FAMILIES + [MF_CASE])
def test_serves_jax_fitted_pose_like_jax(case, tmp_path):
    """JAX's fitted leaves carried into the port's model and saved as a
    port checkpoint, served with --checkpoint in float32.  Where JAX's
    float64 serve of the pose is pinned, the port's float32 marginals are
    within twice JAX's own float32 distance from it (plus 1e-5 of the
    largest value): both packages' float32 serves carry the rounding of
    cond(K + σ²I) ~ 1e4 (the exact Gibbs families) up to cond(U) ~ 1e7 (the
    sparse MV prior).  The deep GP (no float64 pin: JAX draws its ε in x's
    dtype) is held to JAX's float32 serve within 1e-4 of the largest value."""
    ckpt = tmp_path / "jax_fitted.pt"
    argv, _, fitted, draws = pinned(tmp_path, case, "/dev/null", "--checkpoint", str(ckpt))
    cfg = serve.config(argv)
    save_pytree(ckpt, model_of(cfg, fitted, 3 if str(REF[f"{case}.data"]) == "st" else 2))
    with contextlib.redirect_stdout(io.StringIO()):
        out = serve.run(cfg, draws=draws)
    for what in ("mean", "std"):
        got, want32 = out[what], REF[f"{case}.{what}"]
        assert np.isfinite(got).all()
        if f"{case}.{what}_f64" not in REF.files:
            assert np.max(np.abs(got - want32)) <= 1e-4 * np.max(np.abs(want32)), (case, what)
            continue
        want = REF[f"{case}.{what}_f64"]
        allowed = 2 * np.max(np.abs(want32 - want)) + 1e-5 * np.max(np.abs(want))
        assert np.max(np.abs(got - want)) <= allowed, (case, what, np.max(np.abs(got - want)), allowed)


@pytest.mark.parametrize("case", [c for c in FAMILIES + [MF_CASE] if f"{c}.mean_f64" in REF.files])
def test_served_pose_in_float64_matches_jax(case, tmp_path):
    """The serve's ``_predict`` in float64 at JAX's fitted pose against
    JAX's float64 ``_predict`` there, within 1e-8 of the largest value (the
    matrix-free case 1e-6: its solves stop at a tolerance; the sparse MV
    model 1e-5: cond(U) ~ 1e7 times cond(K + σ²I) lifts float64 rounding to
    ~1e-6 in either package)."""
    argv, _, fitted, draws = pinned(tmp_path, case, "/dev/null")
    cfg = serve.config(argv)
    data = serve.training_data(cfg, torch.device("cpu"), torch.float64)
    x, y = data.x, data.y
    _, _, extra = serve._build(cfg.model, x, y, cfg, draws)
    model = model_of(cfg, fitted, x.shape[1], torch.float64)
    with contextlib.redirect_stdout(io.StringIO()):
        mean, var = serve._predict(cfg.model, model, x, y, x, cfg, extra=extra)
    tol = 1e-6 if case.startswith("mf") else 1e-5 if case == "mv_gibbs_sparse" else 1e-8
    for got, want in ((mean.numpy() * data.stdy + data.meany, REF[f"{case}.mean_f64"]),
                      (np.sqrt(var.numpy()) * data.stdy, REF[f"{case}.std_f64"])):
        assert np.max(np.abs(got - want)) <= tol * np.max(np.abs(want)), (case, np.max(np.abs(got - want)))


@pytest.mark.parametrize("case", [c for c in FAMILIES if f"{c}.loss0_f64" in REF.files])
def test_step0_loss_in_float64_matches_jax(case, tmp_path):
    """The serve's loss (``_build``'s, its hoist included) at JAX's init in
    float64 against JAX's float64 loss there, rtol 1e-10: where the float32
    readings part (the sparse MV prior), both packages agree once rounding
    is out of the way."""
    argv, init, _, _ = pinned(tmp_path, case, "/dev/null")
    cfg = serve.config(argv)
    data = serve.training_data(cfg, torch.device("cpu"), torch.float64)
    x, y = data.x, data.y
    _, loss_fn, extra = serve._build(cfg.model, x, y, cfg, {})
    model = model_of(cfg, init, x.shape[1], torch.float64)
    got, want = float(loss_fn(model, x, y, *extra).detach()), float(REF[f"{case}.loss0_f64"])
    assert abs(got - want) <= 1e-10 * abs(want), (case, got, want)


@pytest.mark.parametrize("case", ["gibbs_exact", "mv_gibbs_sparse", "deepgp", "st_nonstationary"])
def test_checkpoint_round_trip_serves_the_same_bits(case, tmp_path):
    """--save_checkpoint after a fit, then --checkpoint (no fit): the same
    predictions, bit for bit, and the CSV written from them."""
    ckpt = tmp_path / "ckpt" / case
    fitted, csv1, _ = serve_case(tmp_path, case, "--save_checkpoint", str(ckpt))
    assert ckpt.is_file()
    out2 = tmp_path / "restored.csv"
    argv, _, _, draws = pinned(tmp_path, case, str(out2), "--checkpoint", str(ckpt))
    with contextlib.redirect_stdout(io.StringIO()):
        restored = serve.run(serve.config(argv), draws=draws)
    assert restored["steps"] == 0
    np.testing.assert_array_equal(restored["mean"], fitted["mean"])
    np.testing.assert_array_equal(restored["std"], fitted["std"])
    assert out2.read_text() == csv1.read_text()


class _W(nn.Module):
    def __init__(self):
        super().__init__()
        self.w = nn.Parameter(torch.ones(1, dtype=torch.float64))


def _cliffed_torch(m, _):
    w = m.w[0]
    return (w - 0.5) ** 2 + 0.0 * torch.sqrt(w + 0.05)


def _cliffed_jax(m, _):
    w = m["w"][0]
    return (w - 0.5) ** 2 + 0.0 * jnp.sqrt(w + 0.05)


def _fit_lines(text: str) -> list:
    return [line for line in text.splitlines() if line.startswith("fit:")]


@pytest.mark.parametrize("lr, backoff", [(2.0, 3), (8.0, 2), (2.0, 0)], ids=["recovers", "exhausts", "off"])
def test_lr_backoff_matches_jax(lr, backoff):
    """A loss that is NaN past a cliff which Adam jumps over at lr ≥ 2 (JAX's
    own test_optim case): the port's ``fit`` retries, halves and reports as
    JAX's does (the same "fit:" lines, so the same retry count and final
    lr), takes the same steps and traces the same losses."""
    with contextlib.redirect_stdout(io.StringIO()) as jout:
        jres = jax_fit({"w": jnp.ones(1)}, _cliffed_jax, jnp.zeros(1), lr=lr, num_steps=60, chunk=6,
                       lr_backoff=backoff)
    with contextlib.redirect_stdout(io.StringIO()) as tout:
        tres = fit(_W(), _cliffed_torch, torch.zeros(1), lr=lr, num_steps=60, chunk=6, lr_backoff=backoff)
    assert _fit_lines(tout.getvalue()) == _fit_lines(jout.getvalue()) and _fit_lines(jout.getvalue())
    assert tres.steps == jres.steps and tres.backoffs == sum("restored" in s for s in _fit_lines(jout.getvalue()))
    assert tres.retried_steps == 6 * tres.backoffs  # each retried chunk ran its 6 steps
    np.testing.assert_allclose(tres.losses, np.asarray(jres.losses), rtol=1e-10, atol=1e-12)


def test_nonfinite_predictions_raise_and_leave_no_checkpoint(tmp_path):
    """A fit that diverges past its back-offs serves non-finite values: the
    CLI raises and saves no checkpoint."""
    ckpt = tmp_path / "never"
    argv = pinned(tmp_path, "st_stationary", str(tmp_path / "p.csv"), "--save_checkpoint", str(ckpt), "--lr",
                  "1e6")[0]
    with contextlib.redirect_stdout(io.StringIO()) as printed, pytest.raises(SystemExit, match="non-finite"):
        serve.main(argv)
    assert "backoffs left" in printed.getvalue()
    assert not ckpt.exists() and not (tmp_path / "p.csv").exists()


@pytest.mark.parametrize("model", [m for m in serve.MODELS if m != "gibbs_exact"])
def test_matrixfree_rejected_for_other_families(model, tmp_path):
    with pytest.raises(SystemExit, match="--matrixfree is implemented for --model gibbs_exact"):
        serve.main(["--model", model, "--matrixfree", "true", "--device", "cpu", "--output", "/dev/null"])


@pytest.mark.parametrize("flags, item", [(["--chunked", "true", "--precond_rank", "16"], "pivchol"),
                                         (["--precond", "nystrom", "--precond_rank", "16"], "nystrom"),
                                         (["--precond_rank", "300"], "nystrom")],
                         ids=["chunked", "nystrom", "auto_nystrom"])
def test_unported_flags_raise_with_their_roadmap_item(flags, item, tmp_path):
    """The flags that raised until their ROADMAP items (queue 1, 4 and 5)
    landed now serve: ``--chunked`` through the host-chunked fit and state,
    ``--precond nystrom`` and the auto rule's Nyström above rank 200 (here
    N = 208, rank 208), at a tiny budget on the CPU, each resolving the
    factor rule ``item``, with finite served values."""
    n = 208
    rng = np.random.default_rng(4)
    x = rng.uniform(-3, 3, size=(n, 2))
    csv = tmp_path / "train.csv"
    np.savetxt(csv, np.column_stack([x, np.sin(x[:, 0]) + 0.1 * rng.normal(size=n)]), delimiter=",",
               header="x0,x1,y", comments="")
    argv = ["--model", "gibbs_exact", "--matrixfree", "true", "--device", "cpu", "--output", "/dev/null",
            "--train_csv", str(csv), "--max_iters", "2", *flags]
    assert serve._matrixfree_setup(serve.config(argv), n)[2] == item
    with contextlib.redirect_stdout(io.StringIO()) as printed:
        mean, std = serve.main(argv)
    assert mean.shape == std.shape == (n,) and np.isfinite(mean).all() and np.isfinite(std).all()
    assert ("chunked fit: 2 steps" in printed.getvalue()) == ("--chunked" in flags)


def test_chunked_fit_has_no_lr_backoff_as_jax(tmp_path):
    """The chunked serve trains with ``fit_chunked``, which has no lr
    back-off in either package (JAX's ``fit_chunked`` takes no
    ``lr_backoff``; its serve passes one to ``fit`` alone): at an lr that
    blows the field up, the port's chunked CLI stops at the first
    non-finite loss with no back-off (the monolithic route backs off, then
    refuses: ``test_nonfinite_predictions_raise_and_leave_no_checkpoint``)
    and refuses to serve the diverged model."""
    import inspect

    assert "lr_backoff" not in inspect.signature(jax_fit_chunked).parameters
    n = 64
    rng = np.random.default_rng(5)
    x = rng.uniform(-3, 3, size=(n, 2))
    csv = tmp_path / "train.csv"
    np.savetxt(csv, np.column_stack([x, np.sin(x[:, 0]) + 0.1 * rng.normal(size=n)]), delimiter=",",
               header="x0,x1,y", comments="")
    argv = ["--model", "gibbs_exact", "--matrixfree", "true", "--device", "cpu", "--output", "/dev/null",
            "--train_csv", str(csv), "--max_iters", "4", "--precond_rank", "16", "--lr", "1e6"]
    assert serve.chunked_fit("gibbs_exact", serve.config([*argv, "--chunked", "true"]))
    assert not serve.chunked_fit("gibbs_exact", serve.config(argv))
    with contextlib.redirect_stdout(io.StringIO()) as printed, pytest.raises(SystemExit, match="non-finite"):
        serve.main([*argv, "--chunked", "true"])
    assert "fit_chunked: non-finite loss at step" in printed.getvalue()
    assert "0 lr back-offs" in printed.getvalue() and "backoffs left" not in printed.getvalue()


def test_unknown_model_and_no_card():
    with pytest.raises(SystemExit, match="unknown --model 'nope'"):
        serve.main(["--model", "nope", "--device", "cpu"])
    if not torch.cuda.is_available():  # the default device is the card, never a fallback
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            serve.main(["--model", "seard", "--max_iters", "1", "--output", "/dev/null"])


def test_points_csv_is_served_in_raw_units(tmp_path):
    """--points_csv: its first d columns are whitened in the training frame,
    served, and written back in raw units; the training sites among them
    serve what the hindcast serves."""
    sites = REF["data.spatial"]
    pts = tmp_path / "pts.csv"
    np.savetxt(pts, np.column_stack([sites[[5, 0, 77], :2], np.arange(3)]), delimiter=",", header="lon,lat,id",
               comments="")
    train_csv = serve.config(pinned(tmp_path, "seard", "/dev/null")[0]).train_csv
    argv = ["--model", "seard", "--max_iters", "3", "--device", "cpu", "--train_csv", train_csv]
    with contextlib.redirect_stdout(io.StringIO()):
        hind, _ = serve.main([*argv, "--output", str(tmp_path / "h.csv")])
        mean, _ = serve.main([*argv, "--points_csv", str(pts), "--output", str(tmp_path / "p.csv")])
    out = np.loadtxt(tmp_path / "p.csv", delimiter=",", skiprows=1)
    assert out.shape == (3, 4)
    np.testing.assert_array_equal(out[:, :2], sites[[5, 0, 77], :2])
    np.testing.assert_allclose(mean, hind[[5, 0, 77]], rtol=1e-5)


def test_padded_query_chunks_equal_one_chunk():
    """The chunk loop with a padded tail (394 = 3 × 128 + 10) serves what
    one call serves."""
    gen = torch.Generator().manual_seed(0)
    x, y, pts = torch.randn(60, 2, generator=gen), torch.randn(60, generator=gen), torch.randn(394, 2, generator=gen)
    model = serve._build("seard", x, y, serve.config(["--device", "cpu"]), {})[0]

    def marginals(m, p):
        d = m.predictive(x, y, p)
        return d.mean, d.var

    whole = serve._run_chunked_predict(marginals, model, pts, 4096)
    chunked = serve._run_chunked_predict(marginals, model, pts, 128)
    for a, b in zip(chunked, whole):
        assert a.shape == (394,)
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5, atol=1e-6)


def test_main_dispatches_list_serve_and_every_experiment(tmp_path):
    """``python -m nonstationary_precip_tpu_torch list`` names JAX's
    experiments and serve, none of them as not yet ported; ``serve`` routes
    to ``serve.main``; precipitation_baselines, the last experiment ported,
    routes to its driver and runs."""
    with contextlib.redirect_stdout(io.StringIO()) as printed:
        assert cli.main(["list"]) is None
    text = printed.getvalue()
    assert all(name in text for name in cli.EXPERIMENTS) and "serve" in text
    assert not cli.NOT_PORTED and "not yet ported" not in text
    with contextlib.redirect_stdout(io.StringIO()):
        mean, std = cli.main(["serve", "--model", "seard", "--max_iters", "2", "--device", "cpu", "--output",
                              str(tmp_path / "s.csv")])
        rmse, nlpd = cli.main(["precipitation_baselines", "--device", "cpu", "--max_iters", "2", "--log_interval",
                               "1", "--logdir", str(tmp_path), "--name", "pb"])
    assert mean.shape == std.shape == (394,) and (tmp_path / "s.csv").is_file()
    assert np.isfinite(rmse) and np.isfinite(nlpd) and (tmp_path / "pb" / "final" / "model").is_file()
    with pytest.raises(SystemExit, match="unknown experiment"):
        cli.main(["nope"])
