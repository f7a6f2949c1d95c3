"""CLI dispatcher: ``python -m nonstationary_precip_tpu_torch <experiment|serve|list> [flags]``.

Counterpart of ``nonstationary_precip_tpu/__main__.py``: lists and launches
the experiment entry points (each also runs standalone via ``python -m
nonstationary_precip_tpu_torch.experiments.<name>``) and the batch-inference
CLI, ``serve``.  ``EXPERIMENTS`` is the JAX package's list; an experiment
the port does not have yet raises with the ROADMAP item that ports it.
"""

import importlib
import sys

EXPERIMENTS = [
    "seard_spatial",
    "spatial_gibbs",
    "spatio_temporal",
    "spatiotemporal_stationary",
    "spatiotemporal_dgp",
    "temporal",
    "deepgp_spatial",
    "precipitation_baselines",
    "sgpr_bench",
    "field_regression",
]

#: Experiments of ``EXPERIMENTS`` not ported yet, with the ROADMAP item that ports each.
NOT_PORTED = {"precipitation_baselines": "ROADMAP queue 1 item 10"}


def _module(name: str):
    if name in NOT_PORTED:
        raise NotImplementedError(f"experiments.{name} is not yet ported: {NOT_PORTED[name]}")
    return importlib.import_module(f"nonstationary_precip_tpu_torch.experiments.{name}")


def main(argv=None):
    argv = sys.argv[1:] if argv is None else list(argv)
    if not argv or argv[0] in ("-h", "--help", "list"):
        print("usage: python -m nonstationary_precip_tpu_torch <experiment|serve> [--flag value ...]")
        print("experiments:")
        for name in EXPERIMENTS:
            if name in NOT_PORTED:
                head = f"(not yet ported: {NOT_PORTED[name]})"
            else:
                doc = (_module(name).__doc__ or "").strip().splitlines()
                head = doc[0] if doc else ""
            print(f"  {name:<28} {head}")
        print("  serve                        batch-inference CLI: fit/restore a model, predict at query points → CSV")
        return None
    name = argv[0]
    if name == "serve":
        from nonstationary_precip_tpu_torch import serve

        return serve.main(argv[1:])
    if name not in EXPERIMENTS:
        raise SystemExit(f"unknown experiment {name!r}; try: python -m nonstationary_precip_tpu_torch list")
    return _module(name).main(argv[1:])


if __name__ == "__main__":
    main()
