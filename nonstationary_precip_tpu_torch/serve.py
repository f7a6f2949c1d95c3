"""Batch-inference CLI: fit (or restore) a model, predict mean and σ at
query points, write them as a CSV in raw data units.

Counterpart of ``nonstationary_precip_tpu/serve.py``, over the same eight
model families (``MODELS``).  A checkpoint restores into a model built from
the same --model/--train_csv/--x_cols flags (the exact Gibbs family's
parameter shapes depend on the data).

    # fit on the bundled UIB data and predict at its own sites
    python -m nonstationary_precip_tpu_torch serve --model gibbs_exact --output preds.csv

    # fit once, save, then serve repeatedly from the checkpoint
    python -m nonstationary_precip_tpu_torch serve --model seard --save_checkpoint ckpt/seard --output /dev/null
    python -m nonstationary_precip_tpu_torch serve --model seard --checkpoint ckpt/seard \\
        --points_csv new_sites.csv --output preds.csv

    # the spatio-temporal cube carries a row index first
    python -m nonstationary_precip_tpu_torch serve --model st_nonstationary \\
        --train_csv data/uib_spatio_temporal.csv --x_cols 1,2,3 --y_col 4

Everything runs on ``--device`` (default cuda, which raises where there is
no card; ``--device cpu`` for checks).  ``--points_csv`` wants a headered
CSV whose first columns are the input coordinates; without it the training
sites are served (a hindcast).  ``--matrixfree true`` (``gibbs_exact``
only) routes fit and predict through the matrix-free CG path
(``GibbsExactGP.loss_matrixfree``, ``posterior_state_matrixfree``): no N×N
matrix, with K2 and K3 on the card.  ``--chunked true`` drives the fit and
the serve through the host-chunked phases (``make_chunked_map_loss``,
``fit_chunked``, the chunked posterior routes: ``--chunk_iters`` iterations
a chunk, at most ``--n_chunks`` of them, 8 for the serving state, stopped
early; ``--bwd_row_chunks`` row blocks of K3's sweep, for parity with the
JAX CLI).  ``--precond``
picks the preconditioner factor: pivoted Cholesky or Nyström, by default
pivoted Cholesky up to rank 200 and Nyström above.  The JAX package's
large-N flagship:

    python -m nonstationary_precip_tpu_torch serve --model gibbs_exact --matrixfree true --chunked true \\
        --precond_rank 1024 --precond nystrom --precond_shift 10 --train_csv big.csv

Randomness comes from the caller, as everywhere in the port: every draw
(the k-means seed row, H₀ and D₀, the deep GP's z and its ε, the matrix-free
probes) comes from a ``torch.Generator`` of its own stream (``STREAMS``),
seeded ``--seed`` + the stream's offset, on the CPU; ``run``'s ``draws``
and ``init`` let a caller hand in other draws and other initial leaves (the
JAX package's, through ``interop``).
"""

from __future__ import annotations

import math
import sys
from dataclasses import dataclass
from pathlib import Path
from typing import Mapping, NamedTuple, Optional

import numpy as np
import torch

from nonstationary_precip_tpu_torch.train.config import ExperimentConfig
from nonstationary_precip_tpu_torch.utils.config import DATASET_DIR, device

MODELS = (
    "seard",
    "gibbs_exact",
    "gibbs_sparse",
    "mv_gibbs",
    "mv_gibbs_sparse",
    "deepgp",
    "st_stationary",
    "st_nonstationary",
)

#: One generator a stream, seeded ``--seed`` + the offset; the matrix-free
#: streams take the JAX serve's offsets (its PRNGKey(seed + 1), (seed + 2)).
STREAMS = {"init": 0, "prior_probes": 1, "probes": 2, "fit": 3, "predict": 4}

#: The matrix-free hoist's and loss's probe counts (the JAX defaults of
#: ``gram_pre_lazy`` and ``loss_matrixfree``), and the prior's rank cap.
PRIOR_PROBES, NUM_PROBES, PRIOR_RANK = 16, 8, 50

#: Predictive samples of the deep GP's served marginals (JAX's ``predict``).
DEEPGP_PRED_SAMPLES = 10

#: The relres gate of the matrix-free variance solves.
RELRES_GATE = 1e-2


@dataclass
class ServeConfig(ExperimentConfig):
    train_csv: str = str(DATASET_DIR / "uib_spatial.csv")
    points_csv: str = ""  # default: serve the training sites
    output: str = "predictions.csv"
    checkpoint: str = ""  # restore fitted params instead of fitting
    save_checkpoint: str = ""  # save fitted params after fitting
    # column selection, e.g. the spatio-temporal cube's first column is a
    # row index: --x_cols 1,2,3 --y_col 4.  Defaults: all-but-last / last.
    x_cols: str = ""
    y_col: int = -1
    # large-N serving (gibbs_exact only): fit and predict matrix-free
    matrixfree: bool = False
    precond_rank: int = 150
    precond_shift: float = 1.0
    # the host-chunked phases for fit and predict (make_chunked_map_loss,
    # fit_chunked): chunk_iters × n_chunks is the mBCG budget (the serving
    # state takes max(n_chunks, 8) chunks); bwd_row_chunks splits K3's sweep
    # into row blocks, for parity with the JAX CLI (there it keeps each
    # device program under the TPU's execution wall; one card has none, and
    # the blocks give the whole sweep's bits in the same time)
    chunked: bool = False
    chunk_iters: int = 8
    n_chunks: int = 4
    bwd_row_chunks: int = 1
    # preconditioner factor rule: pivchol | nystrom | "" = auto (pivchol up
    # to rank 200, nystrom above, the JAX package's measured crossover)
    precond: str = ""


def config(argv=None) -> ServeConfig:
    """The CLI's configuration: the JAX ``main``'s defaults, then ``argv``."""
    return ServeConfig(model="gibbs_exact", max_iters=1000).parse_args(argv)


def generator(cfg: ServeConfig, stream: str) -> torch.Generator:
    """The CPU generator of one draw stream (``STREAMS``)."""
    return torch.Generator().manual_seed(int(cfg.seed) + STREAMS[stream])


def _lazy_block(n: int, cap: int = 2048) -> int:
    """Largest divisor of n that is ≤ cap: the lazy CG row panels must tile
    N exactly."""
    b = min(n, cap)
    while n % b:
        b -= 1
    return b


def _normal(gen: torch.Generator, shape, dev) -> torch.Tensor:
    return torch.randn(shape, generator=gen, dtype=torch.float32).to(dev)


def _matrixfree_setup(cfg: ServeConfig, n: int):
    """(block, rank, precond) of the matrix-free path."""
    rank = min(cfg.precond_rank, n)
    return _lazy_block(n), rank, cfg.precond or ("nystrom" if rank > 200 else "pivchol")


def chunked_fit(name: str, cfg: ServeConfig) -> bool:
    """Whether ``_build`` returns the host-chunked loss (a
    ``ChunkedMAPLoss``, trained by ``fit_chunked``) for this run."""
    return name == "gibbs_exact" and cfg.matrixfree and cfg.chunked


def _build(name: str, train_x: torch.Tensor, train_y: torch.Tensor, cfg: ServeConfig, draws: Mapping):
    """An unfitted model for ``_fit``: ``(model, loss_fn, extra)``, with
    ``extra`` the loop-invariant tensors ``fit`` passes after ``(train_x,
    train_y)`` (the frozen prior's hoisted algebra of the exact Gibbs
    family).  The trainability is each model's default (``requires_grad``).
    ``draws`` may hold the matrix-free probes ("prior_probes": one (u1, u2)
    a dim; "probes": (u1, u2)); the rest is drawn from the streams."""
    from nonstationary_precip_tpu_torch.kernels.base import Scale
    from nonstationary_precip_tpu_torch.kernels.stationary import RBF
    from nonstationary_precip_tpu_torch.models.deep_gp import DeepGP
    from nonstationary_precip_tpu_torch.models.exact_gp import ExactGP
    from nonstationary_precip_tpu_torch.models.gibbs_gp import GibbsExactGP, GibbsSparseGP
    from nonstationary_precip_tpu_torch.ops.kmeans import kmeans_inducing_points
    from nonstationary_precip_tpu_torch.priors.lognormal_process import LogNormalProcess

    if cfg.matrixfree and name != "gibbs_exact":
        raise SystemExit("--matrixfree is implemented for --model gibbs_exact (the other families are "
                         "sparse/minibatched — already large-N)")
    dev, dtype = train_x.device, train_x.dtype
    n, d = train_x.shape
    gen = generator(cfg, "init")

    def kmeans_z(x):
        return kmeans_inducing_points(int(torch.randint(x.shape[0], (), generator=gen)), x, cfg.num_inducing)

    if name == "seard":
        model = ExactGP.create(Scale.create(RBF.create(d, dtype=dtype, device=dev), dtype=dtype, device=dev),
                               mean_type="constant", dtype=dtype, device=dev)
        return model, (lambda m, xx, yy: m.loss(xx, yy)), ()
    if name in ("mv_gibbs", "mv_gibbs_sparse"):
        from nonstationary_precip_tpu_torch.models.multivariate_gibbs_gp import (
            MultivariateGibbsGP,
            SparseMultivariateGibbsGP,
        )

        if d != 2:
            raise SystemExit("the multivariate Gibbs kernel is 2-D only")
        if name == "mv_gibbs":
            model = MultivariateGibbsGP.create(gen, train_x, noise=cfg.noise, dtype=dtype, device=dev)
        else:
            model = SparseMultivariateGibbsGP.create(gen, kmeans_z(train_x), noise=cfg.noise, dtype=dtype,
                                                     device=dev)
        # the H prior and the anchor sites are frozen by design
        return model, (lambda m, xx, yy: m.loss(xx, yy)), ()
    # the latent lengthscale prior: over all d input dims for the spatial
    # Gibbs models, over the 2 spatial dims for the ST sum-kernel model
    prior = LogNormalProcess.create(input_dim=2 if name == "st_nonstationary" else d,
                                    mean=math.log(cfg.prior_mean), outputscale=cfg.prior_scale,
                                    lengthscale=cfg.prior_ell, dtype=dtype, device=dev)
    if name == "gibbs_exact":
        model = GibbsExactGP.create(train_x, prior, noise=cfg.noise, outputscale=cfg.scale, dtype=dtype, device=dev)
        if cfg.matrixfree:
            # the frozen prior's hoist is per-dim pivoted-Cholesky factors and
            # an SLQ logdet constant; the per-step loss is preconditioned mBCG
            # over K2, its backward K3: no N×N matrix on either side
            blk, rank, precond = _matrixfree_setup(cfg, n)
            prior_rank = min(PRIOR_RANK, n)
            if "prior_probes" in draws:
                prior_probes = [tuple(torch.as_tensor(u, dtype=dtype, device=dev) for u in pair)
                                for pair in draws["prior_probes"]]
            else:
                pg = generator(cfg, "prior_probes")
                prior_probes = [(_normal(pg, (prior_rank, PRIOR_PROBES), dev), _normal(pg, (n, PRIOR_PROBES), dev))
                                for _ in range(d)]
            if "probes" in draws:
                probes = tuple(torch.as_tensor(u, dtype=dtype, device=dev) for u in draws["probes"])
            else:
                # fixed probes across steps: common random numbers, as JAX's
                # serve and every measured large-N row
                pg = generator(cfg, "probes")
                probes = (_normal(pg, (rank, NUM_PROBES), dev), _normal(pg, (n, NUM_PROBES), dev))
            pre = model.prior_pre_matrixfree(train_x, prior_probes, rank=prior_rank, block=blk)
            if chunked_fit(name, cfg):
                # the host-chunked phases, the same MAP estimand
                from nonstationary_precip_tpu_torch.models.gibbs_gp import make_chunked_map_loss

                loss = make_chunked_map_loss(d, block=blk, chunk_iters=cfg.chunk_iters, n_chunks=cfg.n_chunks,
                                             tol=1e-6, precond_rank=rank, precond=precond,
                                             precond_shift=cfg.precond_shift, bwd_row_chunks=cfg.bwd_row_chunks)
                return model, loss, (pre, probes)
            return (model,
                    (lambda m, xx, yy, pc: m.loss_matrixfree(xx, yy, probes, pc, block=blk, precond_rank=rank,
                                                             precond=precond, precond_shift=cfg.precond_shift)),
                    (pre,))
        # the frozen prior's (K⁻¹, logdet), hoisted once
        with torch.no_grad():
            pre = prior.gram_pre(train_x)
        return model, (lambda m, xx, yy, pc: m.loss(xx, yy, pc)), (pre,)
    if name == "gibbs_sparse":
        model = GibbsSparseGP.create(kmeans_z(train_x), prior, noise=cfg.noise, outputscale=cfg.scale, dtype=dtype,
                                     device=dev)
        # z trains, so the prior's Grams move with it: nothing to hoist
        return model, (lambda m, xx, yy: m.loss(xx, yy)), ()
    if name == "deepgp":
        model = DeepGP.create(gen, input_dims=d, num_layers=cfg.num_layers, num_inducing=cfg.num_inducing,
                              dtype=dtype, device=dev)
        return model, None, ()  # trained by fit_minibatched
    if name == "st_stationary":
        from nonstationary_precip_tpu_torch.models.spatio_temporal import SpatioTemporalStationary

        if d != 3:
            raise SystemExit("st_stationary expects 3 input columns (time, lon, lat)")
        return SpatioTemporalStationary.create(dtype=dtype, device=dev), (lambda m, xx, yy: m.loss(xx, yy)), ()
    if name == "st_nonstationary":
        from nonstationary_precip_tpu_torch.models.spatio_temporal import SparseSpatioTemporalNonstationary

        if d != 3:
            raise SystemExit("st_nonstationary expects 3 input columns (time, lon, lat)")
        model = SparseSpatioTemporalNonstationary.create(kmeans_z(train_x), prior, dtype=dtype, device=dev)
        return model, (lambda m, xx, yy: m.loss(xx, yy)), ()
    raise SystemExit(f"unknown --model {name!r}; choose from {MODELS}")


def _deepgp_eps(gen: torch.Generator, lead: tuple, num_hidden: int, n: int, dev) -> tuple:
    """One standard-normal tensor (*lead, O, n) per hidden layer, from one
    draw of ``gen``."""
    from nonstationary_precip_tpu_torch.models.deep_gp import NUM_OUTPUT_DIMS

    z = _normal(gen, (*lead, num_hidden, NUM_OUTPUT_DIMS, n), dev)
    return tuple(z[..., i, :, :].contiguous() for i in range(num_hidden))


def _as_eps(arrays, dev) -> tuple:
    return tuple(torch.as_tensor(np.asarray(a), dtype=torch.float32, device=dev) for a in arrays)


def _fit(name: str, model, loss_fn, train_x, train_y, cfg: ServeConfig, extra=(), draws: Mapping = None):
    """Adam on the family's loss at ``cfg``'s budget; returns the
    ``TrainResult``.  ``draws`` may hold the deep GP's per-step ε
    ("eps_train": one (T, S, O, B) array a hidden layer)."""
    from nonstationary_precip_tpu_torch.train.optim import fit, fit_chunked, fit_minibatched, num_minibatch_steps

    draws = draws or {}
    lr = cfg.lr
    if name.startswith("mv_") and cfg.lr == ServeConfig().lr:
        # the Paciorek–Schervish Σ algebra NaNs at the generic Adam default on
        # whitened field data (JAX: lr 0.01 diverges at step 2-3, 0.002
        # trains); only when --lr was left at its default
        lr = 0.002
    if chunked_fit(name, cfg):
        # Adam on the host over the chunked loss, each step's relres kept;
        # no lr back-off, as JAX's chunked serve (fit_chunked has none)
        res = fit_chunked(model, loss_fn, train_x, train_y, extra[0], probe_noise=extra[1], num_steps=cfg.max_iters,
                          lr=lr, log_every=max(cfg.log_interval, 1))
        worst = float(res.relres.max()) if res.steps else float("nan")
        print(f"chunked fit: {res.steps} steps, final loss {float(res.losses[-1]):.6f}, worst relres {worst:.2e}"
              + ("" if worst <= RELRES_GATE else "  [NOT CONVERGED — raise --precond_rank / --precond_shift]"))
        return res
    if name == "deepgp":
        n = train_x.shape[0]
        if "eps_train" in draws:
            eps = _as_eps(draws["eps_train"], train_x.device)
        else:
            steps = num_minibatch_steps(n, cfg.num_epochs, cfg.batch_size)
            eps = _deepgp_eps(generator(cfg, "fit"), (steps, cfg.num_samples), cfg.num_layers,
                              min(cfg.batch_size, n), train_x.device)
        return fit_minibatched(model, lambda m, e, xb, yb: m.loss(xb, yb, num_data=n, eps=e), train_x, train_y,
                               eps, num_epochs=cfg.num_epochs, batch_size=cfg.batch_size, lr=lr)
    # serving must not hand back a NaN model because the lr was a notch too
    # hot for the data: retry from the last finite chunk at half the lr
    # (twice) before giving up
    return fit(model, loss_fn, train_x, train_y, *extra, lr=lr, num_steps=cfg.max_iters,
               log_every=cfg.log_interval * 10, lr_backoff=2)


def _predict(name: str, model, train_x, train_y, pts, cfg: ServeConfig, chunk: int = 4096, extra=(),
             draws: Mapping = None, report: Optional[dict] = None):
    """Predictive marginals (mean, var) at ``pts``, served in fixed-size
    query chunks (the tail padded), so a large ``--points_csv`` costs
    O(chunk²) memory a call.  ``draws`` may hold the deep GP's predictive
    ε ("eps_pred": one (10, O, N*) array a hidden layer).  ``report``, if
    given, receives the matrix-free solves' evidence ("alpha_relres",
    "worst_relres"; chunked, also "alpha_iters" and each query chunk's
    "query_iters")."""
    draws = draws or {}
    report = {} if report is None else report
    if name == "deepgp":
        # sample propagation is O(S·N*·D): no joint covariance to chunk
        if "eps_pred" in draws:
            eps = _as_eps(draws["eps_pred"], pts.device)
        else:
            eps = _deepgp_eps(generator(cfg, "predict"), (DEEPGP_PRED_SAMPLES,), len(model._hidden_stack()),
                              pts.shape[0], pts.device)
        with torch.no_grad():
            mix = model.predict(pts, eps)[0]
        return mix.mean, mix.var

    if cfg.matrixfree and name == "gibbs_exact":
        blk, rank, precond = _matrixfree_setup(cfg, train_x.shape[0])
        pre = extra[0]
        # each chunk is an mBCG with 1 + chunk right-hand sides
        chunk = min(chunk, 1024)
        # amortised serving: α, the factor and the prior's conditioning
        # solves once, then per chunk the cross build and one variance solve;
        # the chunked route takes the keyed rule's factor (--precond) and at
        # least 8 chunks, as JAX's serve does (its monolithic state keeps
        # pivoted Cholesky)
        chunked = dict(precond=precond, chunk_iters=cfg.chunk_iters, n_chunks=max(cfg.n_chunks, 8)) \
            if cfg.chunked else {}
        state = model.posterior_state_matrixfree(train_x, train_y, pre, block=blk, precond_rank=rank,
                                                 precond_shift=cfg.precond_shift, **chunked)
        report["alpha_relres"], report["alpha_iters"] = float(state[0].alpha_relres), state[0].iters
        print(f"posterior state built{' (chunked)' if cfg.chunked else ''}: alpha solve relres="
              f"{report['alpha_relres']:.2e}")
        relres_seen, iters_seen = [], []
        chunked.pop("precond", None)

        def marginals(m, p):
            dist, info = m.posterior_matrixfree_from_state(state, p, noiseless=False, block=blk,
                                                           precond_shift=cfg.precond_shift, return_info=True,
                                                           **chunked)
            relres_seen.append(float(info["relres_max"]))
            iters_seen.append(info.get("iters"))
            return dist.mean, torch.maximum(dist.var, m.likelihood.noise)

        marginals.relres_seen = relres_seen
        out = _run_chunked_predict(marginals, model, pts, chunk)
        report["worst_relres"] = max(relres_seen)
        if cfg.chunked:
            report["query_iters"] = iters_seen
        return out

    def marginals(m, p):
        dist = m.predictive(train_x, train_y, p)
        # predictive variance = posterior + noise ≥ noise: floor the float32
        # cancellation at that physical bound
        return dist.mean, torch.maximum(dist.var, m.likelihood.noise)

    return _run_chunked_predict(marginals, model, pts, chunk)


def _run_chunked_predict(marginals, model, pts, chunk: int):
    """The fixed-size query-chunk loop and the convergence report."""
    n = pts.shape[0]
    with torch.no_grad():
        if n <= chunk:
            out = marginals(model, pts)
        else:
            k = -(-n // chunk)
            pad = k * chunk - n
            if pad:
                pts = torch.cat([pts, pts[:1].expand(pad, pts.shape[1])])
            means, vars_ = zip(*(marginals(model, pts[i * chunk:(i + 1) * chunk]) for i in range(k)))
            out = torch.cat(means)[:n], torch.cat(vars_)[:n]
    relres = getattr(marginals, "relres_seen", None)
    if relres:
        worst = max(relres)
        # the training-solve gate: a serve whose variance solves stalled above
        # it rides a different (unconverged) estimator, so say so loudly
        status = "ok" if worst <= RELRES_GATE else "NOT CONVERGED"
        print(f"matrix-free variance solves: worst relres={worst:.2e} over {len(relres)} chunk(s) [{status}]")
        if worst > RELRES_GATE:
            print("WARNING: raise --precond_rank (or --precond_shift) and re-serve; predictions below ride an "
                  "unconverged solve", flush=True)
    return out


class TrainingData(NamedTuple):
    raw_x: np.ndarray  # (N, d) the selected input columns, raw units
    raw_y: np.ndarray  # (N,)
    x: torch.Tensor  # (N, d) whitened
    y: torch.Tensor  # (N,)
    meanx: np.ndarray
    stdx: np.ndarray
    meany: float
    stdy: float


def training_data(cfg: ServeConfig, dev, dtype=torch.float32) -> TrainingData:
    """``--train_csv``'s columns (``--x_cols`` / ``--y_col``; default all
    but the last / the last), whitened in the selected-column frame
    (ddof = 1) and rounded to float32, the serve's precision, then held in
    ``dtype`` on ``dev``: a float64 ``dtype`` gives the serve's inputs
    without further rounding."""
    from nonstationary_precip_tpu_torch.data.dataprep import load_csv

    data = load_csv(Path(cfg.train_csv))
    if cfg.x_cols:
        raw_x = data[:, [int(s) for s in cfg.x_cols.split(",")]]
    else:
        raw_x = np.delete(data, cfg.y_col % data.shape[1], axis=1)
    raw_y = data[:, cfg.y_col]
    meanx, stdx = raw_x.mean(axis=0), raw_x.std(axis=0, ddof=1)
    meany, stdy = float(raw_y.mean()), float(raw_y.std(ddof=1))

    def whitened(a):
        return torch.as_tensor(a.astype(np.float32), device=dev).to(dtype)

    return TrainingData(raw_x, raw_y, whitened((raw_x - meanx) / stdx), whitened((raw_y - meany) / stdy), meanx,
                        stdx, meany, stdy)


def run(cfg: ServeConfig, *, init: Optional[Mapping[str, np.ndarray]] = None,
        draws: Optional[Mapping] = None) -> dict:
    """The whole serve; returns the served (mean, std) in raw units and
    what the run measured: the fit's losses, steps, back-offs and seconds
    (its wall, and CUDA events after the first step on the card), the serve
    seconds and, for a hindcast, the RMSE at the training sites.

    ``init``: a JAX model's leaves (numpy, by dotted path) to start from in
    place of the drawn init (carried by ``interop``); ``draws``: draws to use
    in place of the streams' ("eps_train", "eps_pred", "prior_probes",
    "probes")."""
    from nonstationary_precip_tpu_torch import interop
    from nonstationary_precip_tpu_torch.data.dataprep import load_csv
    from nonstationary_precip_tpu_torch.train.checkpoint import restore_pytree, save_pytree
    from nonstationary_precip_tpu_torch.train.optim import _Clock

    if cfg.model not in MODELS:
        raise SystemExit(f"unknown --model {cfg.model!r}; choose from {MODELS}")
    draws = draws or {}
    dev = device(cfg.device)

    data = training_data(cfg, dev)
    train_x, train_y = data.x, data.y
    model, loss_fn, extra = _build(cfg.model, train_x, train_y, cfg, draws)
    if init is not None:
        model = interop.serve_model_from_jax(cfg.model, init, train_x.shape[-1], dev, num_layers=cfg.num_layers)
    out = {"n_train": int(train_x.shape[0]), "losses": np.zeros((0,)), "steps": 0, "executed": 0,
           "backoffs": 0, "fit_seconds": 0.0, "train_seconds": 0.0, "steps_per_s": float("nan")}
    if cfg.checkpoint:
        model = restore_pytree(cfg.checkpoint, model)
        print(f"restored {cfg.model} checkpoint from {cfg.checkpoint}")
    else:
        clock = _Clock(dev)
        clock.start()
        res = _fit(cfg.model, model, loss_fn, train_x, train_y, cfg, extra, draws)
        clock.stop()
        model = res.model
        # the clock ran through every retried chunk: rate the steps it saw
        executed = res.steps + res.retried_steps
        steps_per_s = (executed - 1) / res.seconds if res.seconds > 0 else float("nan")
        out.update(losses=res.losses, steps=res.steps, executed=executed, backoffs=res.backoffs,
                   fit_seconds=clock.seconds(), train_seconds=res.seconds, steps_per_s=steps_per_s)
        if res.relres is not None:  # the chunked fit's evidence
            out.update(fit_relres=res.relres, fit_iters=res.iters)
        print(f"fitted {cfg.model} in {out['fit_seconds']:.1f}s: {res.steps} steps ({executed} run), "
              f"{steps_per_s:.1f} steps/s after the first, {out['backoffs']} lr back-offs")

    # query points: raw input coordinates → the training whitening frame
    if cfg.points_csv:
        raw_pts = load_csv(Path(cfg.points_csv))[:, : train_x.shape[-1]]
    else:
        raw_pts = data.raw_x
    pts = torch.as_tensor((raw_pts - data.meanx) / data.stdx, dtype=torch.float32, device=dev)

    clock = _Clock(dev)
    clock.start()
    mean_t, var_t = _predict(cfg.model, model, train_x, train_y, pts, cfg, extra=extra, draws=draws, report=out)
    clock.stop()
    out["serve_seconds"] = clock.seconds()
    mean = mean_t.double().cpu().numpy() * data.stdy + data.meany  # back to raw data units
    std = np.sqrt(np.maximum(var_t.double().cpu().numpy(), 0.0)) * data.stdy
    print(f"served {len(pts)} points in {out['serve_seconds']:.2f}s")
    if not (np.isfinite(mean).all() and np.isfinite(std).all()):
        raise SystemExit("non-finite predictions: training diverged (fit prints a non-finite-loss warning when so) "
                         "— lower --lr or --max_iters, or serve from a known-good --checkpoint")
    # only a checkpoint that passed the finite-prediction gate is saved: a
    # diverged fit never leaves a NaN checkpoint behind
    if not cfg.checkpoint and cfg.save_checkpoint:
        save_pytree(cfg.save_checkpoint, model)
        print(f"saved checkpoint to {cfg.save_checkpoint}")

    if cfg.output and cfg.output != "/dev/null":
        path = Path(cfg.output)
        cols = [raw_pts[:, i] for i in range(raw_pts.shape[1])] + [mean, std]
        header = ",".join(f"x{i}" for i in range(raw_pts.shape[1])) + ",pred_mean,pred_std"
        np.savetxt(path, np.stack(cols, axis=1), delimiter=",", header=header, comments="")
        print(f"wrote {path} ({len(mean)} rows)")
        out["csv"] = path
    if not cfg.points_csv:
        out["hindcast_rmse"] = float(np.sqrt(np.mean((mean - data.raw_y) ** 2)))
    out.update(mean=mean, std=std)
    return out


def main(argv=None):
    """The CLI: returns the served (mean, std) in raw units, as the JAX
    ``main`` does."""
    out = run(config(argv))
    return out["mean"], out["std"]


if __name__ == "__main__":
    main(sys.argv[1:])
