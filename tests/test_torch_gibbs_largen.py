"""The port's large-N experiment (``nonstationary_precip_tpu_torch/
experiments/gibbs_largen.py``) against the JAX package's, float32 on the
CPU.

The JAX side is the loop of ``nonstationary_precip_tpu.experiments.
gibbs_largen`` as ``tools/pin_jax_largen.py`` composes it; the port gets the
normal draws that JAX's key yields for the probes, so both train on the same
probes.  On the CPU the port's fused builder and panel VJP run their plain
versions.  The N = 2048 fixture pinned by that tool is what chip_smoke.py
holds the card's run to; here the port's CPU run is held to its step-0 loss.
"""

import importlib.util

import numpy as np
import pytest
import torch

from nonstationary_precip_tpu_torch.experiments.gibbs_largen import LargeNConfig, _data, run
from nonstationary_precip_tpu_torch.interop import largen_params_from_jax
from nonstationary_precip_tpu_torch.utils.config import BASE_PATH

torch.set_num_threads(1)
FIXTURE = BASE_PATH / "tests" / "fixtures" / "jax_gibbs_largen_ref.npz"
# step 0: both f32 runs of the same estimator on the same probes, summed in
# another order (measured 6e-6 at N = 2048); later steps: Adam's first steps
# are ~lr·sign(g), so per-point log-ℓ components whose gradient is near zero
# move apart, and the loss follows (measured 6e-3 at step 19, N = 2048).
RTOL_STEP0 = 1e-3


def _pin_tool():
    spec = importlib.util.spec_from_file_location("pin_jax_largen", BASE_PATH / "tools" / "pin_jax_largen.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def small_runs():
    pin = _pin_tool()
    n, steps, rank, iters = 256, 3, 20, 16
    ref = pin.jax_largen(n, steps, rank, iters)
    out = run(LargeNConfig(n=n, steps=steps, rank=rank, iters=iters, device="cpu"),
              probe_noise=(ref["u1"], ref["u2"]))
    return ref, out


def test_port_run_matches_jax_loop_losses_and_gate(small_runs):
    """Per-step losses, the trained-pose diagnostics and the dense-oracle
    comparison of the port's run against the JAX loop, N = 256."""
    ref, out = small_runs
    # measured: losses 1e-6 apart, relres 1e-3 and 2e-2 relative (a residual
    # of 2e-4 is itself rounding-sized), cosine 2e-7 apart
    np.testing.assert_allclose(out["losses"], ref["losses"], rtol=1e-4)
    assert out["diag"]["broke"] == ref["diag"]["broke"] is False
    assert out["diag"]["iters_max"] == ref["diag"]["iters_max"]
    np.testing.assert_allclose(out["diag"]["relres_solve"], ref["diag"]["relres_solve"], rtol=0.1)
    np.testing.assert_allclose(out["loss_dense"], ref["loss_dense"], rtol=1e-4)
    np.testing.assert_allclose(out["loss_lazy"], ref["loss_lazy"], rtol=1e-4)
    assert abs(out["grad_cosine"] - ref["grad_cosine"]) < 1e-4 and out["grad_cosine"] >= 0.98


def test_port_trained_params_match_jax_through_interop(small_runs):
    """The trained parameters, carried from JAX with largen_params_from_jax
    (measured: the field 4e-5 apart at most, 2e-7 in the median; Adam's
    ~lr·sign(g) steps leave a near-zero gradient component free to move
    further, so the bound is 1e-3)."""
    ref, out = small_runs
    jp = largen_params_from_jax(ref["params"], "cpu")
    assert set(jp) == set(out["params"]) and jp["log_ell_pp"].shape == (256, 2)
    for k in ("raw_s2", "log_noise"):
        np.testing.assert_allclose(out["params"][k], jp[k].numpy(), rtol=1e-4, atol=1e-5)
    diff = np.abs(out["params"]["log_ell_pp"] - jp["log_ell_pp"].numpy())
    assert diff.max() <= 1e-3 and np.median(diff) <= 1e-5
    with pytest.raises(KeyError, match="raw_s2"):
        largen_params_from_jax({"log_ell_pp": np.zeros((4, 2)), "log_noise": 0.0}, "cpu")


def test_port_cpu_run_matches_pinned_step0_loss():
    """The port on the fixture's data and draws, one step at N = 2048: its
    step-0 loss against the pinned JAX run's (chip_smoke.py's tolerance)."""
    ref = np.load(FIXTURE)
    assert int(ref["n"]) == 2048 and ref["losses"].shape == (int(ref["steps"]),)
    x, y = _data(int(ref["n"]))
    np.testing.assert_array_equal(x.numpy(), ref["x"])
    np.testing.assert_allclose(y.numpy(), ref["y"], rtol=0, atol=2e-7)
    cfg = LargeNConfig(n=int(ref["n"]), steps=1, rank=int(ref["rank"]), iters=int(ref["iters"]), device="cpu")
    out = run(cfg, probe_noise=(ref["u1"], ref["u2"]), data=(ref["x"], ref["y"]))
    np.testing.assert_allclose(out["losses"][0], ref["losses"][0], rtol=RTOL_STEP0)
