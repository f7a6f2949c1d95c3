"""The float32 serve's rounding at a pinned JAX serve's fitted pose, beside
what a model that is slightly wrong reads there.

For one case of tests/fixtures/jax_serve_ref.npz (tools/pin_jax_serve.py;
default the ST nonstationary model), prints one JSON line with the largest
error of the served mean and σ, in raw units, for
  * "as_served": the port's float32 serve of JAX's fitted leaves, rows and
    inducing points in the fixture's order, against JAX's float64 serve
    (the reading chip_smoke.py's serve_ref holds);
  * "reordered": the port's float32 serve with the training rows and the
    inducing points in --orders seeded orders (the same function in exact
    arithmetic; each order rounds its sums and factorisations differently),
    against the port's float64 serve, one entry an order (chip_smoke.py's
    serve_ref takes the largest, on the card, with the same seed);
  * "perturbed": the port's float32 serve with one leaf 1 % off (the
    latent lengthscale field, the noise, the spatial outputscale), against
    JAX's float64 serve: readings of a wrong model that a check must refuse;
and "float64": the port's float64 serve against JAX's, relative to the
largest value; for the ST model also "k_zz", its inducing Grams' condition
(spatial) and numerical rank (temporal), in float64.

    python tools/probe_serve_f32.py --device cpu
    python tools/probe_serve_f32.py --device cuda --orders 16
"""

import argparse
import contextlib
import io
import json
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from nonstationary_precip_tpu_torch import interop, serve  # noqa: E402
from nonstationary_precip_tpu_torch.kernels.gibbs import gibbs_gram  # noqa: E402
from nonstationary_precip_tpu_torch.models.likelihoods import _NOISE_FLOOR  # noqa: E402
from nonstationary_precip_tpu_torch.models.spatio_temporal import SPATIAL_DIMS  # noqa: E402

REF = ROOT / "tests" / "fixtures" / "jax_serve_ref.npz"
#: the leaves that follow the inducing points' order
INDUCING_LEAVES = ("z", "log_ell_z")


def _softplus(r):
    return np.log1p(np.exp(r))


def _inv_softplus(v):
    return np.log(np.expm1(v))


def perturbations(fitted: dict) -> dict:
    """The fitted leaves with one of them 1 % off in its constrained value."""
    out = {"ell_field_x1.01": {**fitted, "log_ell_z": fitted["log_ell_z"] + np.log(1.01)}}
    raw = fitted["likelihood.raw_noise"]
    out["noise_x1.01"] = {**fitted, "likelihood.raw_noise":
                          _inv_softplus(1.01 * (_softplus(raw) + _NOISE_FLOOR) - _NOISE_FLOOR)}
    raw = fitted["raw_spatial_outputscale"]
    out["spatial_outputscale_x1.01"] = {**fitted, "raw_spatial_outputscale": _inv_softplus(1.01 * _softplus(raw))}
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--case", default="st_nonstationary")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--orders", type=int, default=16)
    ap.add_argument("--seed", type=int, default=17, help="seed of the orders (chip_smoke.py's SERVE_REORDER_SEED)")
    args = ap.parse_args(argv)

    dev = torch.device(args.device)
    ref = np.load(REF)
    with tempfile.TemporaryDirectory() as tmp:
        argv_case, _, fitted, draws = interop.serve_case_from_jax(ref, args.case, tmp)
        cfg = serve.config([*argv_case, "--device", args.device, "--output", "/dev/null"])
        data = serve.training_data(cfg, dev, torch.float64)
    d = data.x.shape[1]

    def served(params, rows, dtype):
        x, y = data.x[rows].to(dtype), data.y[rows].to(dtype)
        _, _, extra = serve._build(cfg.model, x, y, cfg, draws)
        model = interop.serve_model_from_jax(cfg.model, params, d, dev, dtype, num_layers=cfg.num_layers)
        with contextlib.redirect_stdout(io.StringIO()), torch.no_grad():
            mean, var = serve._predict(cfg.model, model, x, y, x, cfg, extra=extra)
        return mean.double().cpu().numpy() * data.stdy + data.meany, np.sqrt(var.double().cpu().numpy()) * data.stdy

    def errs(got, want):
        return {w: float(np.max(np.abs(g - v))) for w, g, v in zip(("mean", "std"), got, want)}

    jax64 = (ref[f"{args.case}.mean_f64"], ref[f"{args.case}.std_f64"])
    ident = torch.arange(len(data.y), device=dev)
    port64 = served(fitted, ident, torch.float64)
    out = {"case": args.case, "device": torch.cuda.get_device_name(0) if dev.type == "cuda" else "cpu",
           "as_served": errs(served(fitted, ident, torch.float32), jax64),
           "jax_float32": errs((ref[f"{args.case}.mean"], ref[f"{args.case}.std"]), jax64),
           "float64": max(errs(port64, jax64)[w] / float(np.max(np.abs(v))) for w, v in zip(("mean", "std"), jax64))}
    rng = np.random.default_rng(args.seed)
    leaves = [k for k in INDUCING_LEAVES if k in fitted]
    out["reordered"] = []
    for _ in range(args.orders):
        px = rng.permutation(len(data.y))
        pz = rng.permutation(len(fitted[leaves[0]])) if leaves else None
        params = {k: v[pz] if k in leaves else v for k, v in fitted.items()}
        got = served(params, torch.as_tensor(px, device=dev), torch.float32)
        inv = np.argsort(px)
        out["reordered"].append(errs((got[0][inv], got[1][inv]), port64))
    if args.case == "st_nonstationary":
        model = interop.serve_model_from_jax(cfg.model, fitted, d, dev, torch.float64)
        with torch.no_grad():
            zs, ell = model.z[:, SPATIAL_DIMS], torch.exp(model.log_ell_z)
            ev_sp = torch.linalg.eigvalsh(gibbs_gram(zs, ell, zs, ell))
            ev_t = torch.linalg.eigvalsh(model.temporal_kernel(model.z))
        out["k_zz"] = {"spatial_cond": float(ev_sp[-1] / ev_sp[0]),
                       "temporal_rank": int((ev_t > 1e-12 * ev_t[-1]).sum()), "m": len(ev_t)}
        out["perturbed"] = {name: errs(served(p, ident, torch.float32), jax64)
                            for name, p in perturbations(fitted).items()}
    print(json.dumps(out))


if __name__ == "__main__":
    main()
