"""The port's production training driver (``experiments/precipitation_baselines``)
against the JAX driver, float32 on the CPU.

The JAX side is ``tools/pin_jax_baselines.py``'s pinned run of JAX's own
``main`` on tests/test_precip_baselines.py's argv, exact and sparse
(tests/fixtures/jax_baselines_ref.npz, the fixture chip_smoke.py's
``baselines_ref`` reads); the sparse run starts from JAX's k-means centres,
carried across, where the port seeds its k-means at another row.

Tolerances, float32 against float32:
  * the step-0 loss, at the same init on both sides: 2e-5 relative (a
    float32 loss over N = 316 with noise 0.011, where cond(K) ~ 1e5;
    measured up to 5.1e-6 from JAX's at 1 and 8 torch threads);
  * the objective records at steps 10 and 20: 1e-3·max(1, |objective|),
    the trajectories' float32 drift (measured: the exact run's step-20
    objective 1.5e-4 apart, each side within 1.7e-4 of the port's float64
    run);
  * RMSE and raw RMSE 2e-3 relative, NLPD 2e-2: twice the sum of the two
    sides' measured float32 distances from the port's float64 run of the
    exact case (which meets JAX's float64 evaluation to 5e-12): at step 10
    RMSE 7.3e-4 (port) and 2.1e-4 (JAX), NLPD 6.3e-3 and 1.2e-3 (the joint
    NLPD's K_ss − vᵀv loses digits to cancellation; at one fixed pose the
    float32 evaluation alone moves it by +1.8e-3 in the port and −1.8e-3
    in JAX);
  * noise and outputscale are frozen: equal to 1e-6.
"""

import contextlib
import io
import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from nonstationary_precip_tpu.experiments import precipitation_baselines as jax_pb
from nonstationary_precip_tpu_torch import __main__ as cli
from nonstationary_precip_tpu_torch.data.dataprep import load_csv
from nonstationary_precip_tpu_torch.experiments import precipitation_baselines as pb
from nonstationary_precip_tpu_torch.train.checkpoint import restore_pytree

torch.set_num_threads(1)

REF = Path(__file__).resolve().parent / "fixtures" / "jax_baselines_ref.npz"
STEP0_RTOL = 2e-5
OBJECTIVE_TOL = 1e-3
METRIC_RTOL = {"rmse": 2e-3, "rmse_raw": 2e-3, "nlpd": 2e-2}


def run_port(logdir, name, argv, z=None, monkeypatch=None):
    """The port's driver on ``argv`` on the CPU, quietly; with ``z``, its
    k-means returns these centres.  Returns (run's output, its records)."""
    if z is not None:
        monkeypatch.setattr(pb, "kmeans_inducing_points",
                            lambda first, x, m: torch.as_tensor(z, dtype=x.dtype, device=x.device))
    cfg = pb.default_config().parse_args([*argv, "--logdir", str(logdir), "--name", name, "--device", "cpu"])
    with contextlib.redirect_stdout(io.StringIO()) as printed:
        out = pb.run(cfg)
    out["printed"] = printed.getvalue()
    recs = [json.loads(line) for line in (Path(logdir) / name / "train.jsonl").read_text().splitlines()]
    return out, recs


@pytest.fixture(scope="module")
def ref():
    return np.load(REF)


@pytest.fixture(scope="module")
def runs(ref, tmp_path_factory):
    """Both cases of the pinned runs, by the port, once per module."""
    logdir = tmp_path_factory.mktemp("baselines")
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        for case in ("exact", "sparse"):
            z = ref[f"{case}.z"] if f"{case}.z" in ref.files else None
            out[case] = run_port(logdir, case, list(ref[f"{case}.argv"]), z, mp)
    return out


@pytest.mark.parametrize("case", ["exact", "sparse"])
def test_driver_matches_the_pinned_jax_run(case, ref, runs):
    """The step-0 loss, the JSONL records, the final metrics, the run
    directory's entries, the parameter table's trainable total and the
    final line, against JAX's driver on the same argv."""
    out, recs = runs[case]
    keys = list(ref["record_keys"])
    jrecs = [dict(zip(keys, row)) for row in ref[f"{case}.records"]]
    losses = ref[f"{case}.losses"]
    assert out["losses"].shape == losses.shape and out["steps"] == len(losses)
    assert abs(out["losses"][0] - losses[0]) <= STEP0_RTOL * abs(losses[0])
    assert [r["step"] for r in recs] == [int(r["step"]) for r in jrecs]
    for got, want in zip(recs, jrecs):
        assert sorted(got) == sorted(["time", *keys])
        assert abs(got["objective"] - want["objective"]) <= OBJECTIVE_TOL * max(1.0, abs(want["objective"]))
        for k in ("noise", "outputscale"):
            assert got[k] == pytest.approx(want[k], rel=1e-6)
        for k, rtol in METRIC_RTOL.items():
            assert got[k] == pytest.approx(want[k], rel=rtol), k
    assert out["rmse"] == pytest.approx(float(ref[f"{case}.rmse"]), rel=METRIC_RTOL["rmse"])
    assert out["nlpd"] == pytest.approx(float(ref[f"{case}.nlpd"]), rel=METRIC_RTOL["nlpd"])
    assert out["rmse"] == recs[-1]["rmse"] and out["nlpd"] == recs[-1]["nlpd"]
    run = out["logdir"]
    assert sorted(p.name for p in run.iterdir()) == list(ref[f"{case}.files"])
    for tag in ("best", "best_rmse", "best_nlpd", "final", "init_model"):
        assert (run / tag / "model").is_file()
    assert json.loads((run / "final" / "meta.json").read_text()) == {"step": 20}
    assert int((run / "params.txt").read_text().splitlines()[-1].split(":")[-1]) == int(ref[f"{case}.params_total"])
    assert json.loads((run / "config.json").read_text())["device"] == "cpu"
    assert f"final: steps 20  loss {out['losses'][-1]:.4f}" in out["printed"]


def test_resume_continues_from_final_and_serves_its_predictions(runs, tmp_path):
    """A run resumed from the exact run's final/ starts where it ended (the
    JAX test's criterion), and the restored model serves the trained
    model's predictions bit for bit."""
    out, recs = runs["exact"]
    final = out["logdir"] / "final"
    restored = restore_pytree(final / "model", pb.build_model(pb.default_config(), out["tensors"][0]))
    trained_pred = pb.metrics(out["model"], out["tensors"], out["stdy"])[0]
    restored_pred = pb.metrics(restored, out["tensors"], out["stdy"])[0]
    assert torch.equal(restored_pred.mean, trained_pred.mean) and torch.equal(restored_pred.cov, trained_pred.cov)
    argv = ["--inference", "exact", "--max_iters", "10", "--log_interval", "10", "--test_interval", "10",
            "--threshold", "0", "--resume", str(final)]
    out2, recs2 = run_port(tmp_path, "t2", argv)
    assert f"resumed model from {final}" in out2["printed"]
    assert abs(out2["losses"][0] - out["losses"][-1]) < 0.05 * abs(out["losses"][-1]) + 1e-2
    assert abs(recs2[0]["objective"] - recs[-1]["objective"]) < 0.5 * abs(recs[-1]["objective"]) + 0.1


@pytest.mark.parametrize("test_type", ["censored", "random"])
def test_splits_are_jax_splits_bit_for_bit(test_type):
    """The censored and the random split of the bundled data from
    ``default_rng(173)``, row for row JAX's."""
    data = load_csv(pb.default_config().data)
    x, y = data[:, :-1], data[:, -1]
    name = f"{test_type}_split"
    got = getattr(pb, name)(x, y, np.random.default_rng(173), frac=0.2)
    want = getattr(jax_pb, name)(x, y, np.random.default_rng(173), frac=0.2)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


def test_censored_driver_run(tmp_path):
    """The driver with --test_type censored: finite metrics on the
    held-out box, 78 rows of 394."""
    argv = ["--inference", "exact", "--max_iters", "4", "--log_interval", "2", "--test_interval", "2",
            "--test_type", "censored"]
    out, recs = run_port(tmp_path, "c", argv)
    assert np.isfinite(out["rmse"]) and np.isfinite(out["nlpd"]) and len(recs) == 2
    assert out["tensors"][2].shape == (78, 2)


def test_driver_refuses_an_absent_card_and_unreadable_netcdf(tmp_path):
    """The default device is the card, and the run raises where there is
    none; a netCDF path raises ImportError without xarray, as in JAX."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        pb.main(["--logdir", str(tmp_path), "--name", "x", "--max_iters", "1"])
    with pytest.raises(ImportError, match="xarray"):
        pb.main(["--logdir", str(tmp_path), "--name", "y", "--data", str(tmp_path / "p.nc"), "--device", "cpu"])


def test_plot_step_says_once_that_matplotlib_is_missing(tmp_path, monkeypatch):
    """--plot_interval without matplotlib: one line, no figure, the run
    goes on; with it (this sandbox has it), the figures reach the logger."""
    argv = ["--inference", "exact", "--max_iters", "2", "--log_interval", "1", "--test_interval", "1",
            "--plot_interval", "1"]
    drawn = []
    monkeypatch.setattr(pb.MetricsLogger, "figure", lambda self, step, tag, fig: drawn.append((step, tag)))
    with monkeypatch.context() as mp:
        mp.setitem(sys.modules, "matplotlib", None)
        out, recs = run_port(tmp_path, "np", argv)
    assert out["printed"].count("matplotlib does not import") == 1 and not drawn and len(recs) == 2
    pytest.importorskip("matplotlib")
    run_port(tmp_path, "p", argv)
    assert drawn == [(s, t) for s in (1, 2) for t in ("pred_mean", "pred_std", "lengthscale_0")]


def test_cli_lists_and_dispatches_the_driver(tmp_path):
    """``python -m nonstationary_precip_tpu_torch precipitation_baselines``
    runs the driver; ``list`` shows no experiment as not yet ported."""
    assert cli.NOT_PORTED == {}
    with contextlib.redirect_stdout(io.StringIO()) as printed:
        cli.main(["list"])
        r, nl = cli.main(["precipitation_baselines", "--device", "cpu", "--logdir", str(tmp_path), "--name", "m",
                          "--inference", "sparse", "--num_inducing", "8", "--max_iters", "2", "--log_interval", "1"])
    assert "not yet ported" not in printed.getvalue() and "Production-style training driver" in printed.getvalue()
    assert np.isfinite(r) and np.isfinite(nl)
