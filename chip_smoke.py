#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one CUDA card.

Drives the port's main paths and checks every hand-written kernel on them
against its plain PyTorch version.  The paths are the 10-split exact
Gibbs MAP experiment of ``nonstationary_precip_tpu_torch.experiments.
spatial_gibbs`` on the real UIB data (10 splits × 316 training points, K1),
the large-N matrix-free gate of ``experiments.gibbs_largen`` at N = 16384
(K2 and K3), the 10-split DSVI deep GP of ``experiments.deepgp_spatial``
and the field regression of ``experiments.field_regression`` (K4 and K7),
the stationary exact GP of ``experiments.exact_largen`` (the dense MLL loop
at N = 1024..8192, K10a and K5; the matrix-free gate at N = 16384, K6) with
``experiments.seard_spatial`` and ``experiments.temporal``, and the dense
Gibbs MAP rows of ``experiments.exact_largen.gibbs_dense`` at N = 1024 and
1280 with their predictive (K8, K9, K10a, K11), and the matrix-free Gibbs
MAP flow with its prior of ``examples.quickstart_gibbs_largen`` at N = 16384
(K2 and K3), and the sparse and spatio-temporal models: ``experiments.
spatial_gibbs --inference sparse`` (K9 on split-stacked Grams),
``experiments.spatio_temporal`` and ``spatiotemporal_stationary`` (K9 in
the nonstationary model), ``experiments.sgpr_bench`` (K10a in its
predictive's NLPD) and ``experiments.spatiotemporal_dgp`` (K4), and the
serving CLI, ``serve``, over its eight model families (K9, K4, K7, and K2
and K3 on its matrix-free path), and the production driver
``experiments.precipitation_baselines`` (K9; K8, K10a and K11 at N = 1024),
the deep GP's full-covariance loss (K4), the dense CG solver and the
ported quickstarts (K9, K4, K7, K6).  K10b and
K10c, which no path runs, are driven through their
own entries, ``ops.chol_inv.chol_inv_batched`` and
``ops.chol_stream.streaming_cholesky_v1``.  Each path is driven with
every launch count set to 0 just before it and read just after.  Phases,
one JSON line each:

 1. device     — the card's name; nvidia-smi's name and power limit;
 2. build      — K1 (csrc/chol_inv_cluster.cu), K2/K3/K6 (csrc/gibbs_matvec.cu),
                  K4 (csrc/svgp_precompute.cu; K1 and K4 on the cluster
                  header csrc/chol_inv_cluster.cuh), K5 (csrc/chol_stream.cu),
                  K7 (csrc/elbo_fused.cu), K9 (csrc/gibbs_gram.cu), K10a
                  (csrc/chol_blocked.cu), K11 (csrc/trsm.cu), K8
                  (csrc/gibbs_fused.cu), K10c (csrc/chol_stream_v1.cu; K10b
                  is K1's library with its retry off) and K12
                  (csrc/se_matvec_f64.cu), eleven nvcc runs started together, in
                  seconds, with each kernel's registers, spills and shared
                  memory, and each library's sources (its .cu and the
                  headers it includes);
 3. k1         — K1 against its plain version at the slice's shape (10, 316)
                  on the real stacked Gibbs Gram and on random SPD stacks at
                  316 and 384 (each also held to the backward-error bound
                  γ_(N+1)|L||Lᵀ|), N = 384 whole in a cluster's shared
                  memory, ten clusters co-resident, a rank-deficient member
                  through the jitter retry, bitwise repeat, then the median
                  time of each;
 4. slice      — the experiment on the card (300 Adam steps by default): K1's
                  launch count over the run, K9's (one a step on the stacked
                  Gram, two in the evaluation, three in the last split's
                  field prediction), finite and falling losses, the
                  per-split losses at steps 0 and 50 against the JAX package's
                  pinned float32 values (tests/fixtures/jax_spatial_gibbs_ref.npz),
                  steps/s, mean RMSE/NLPD, the field CSV's shape;
 5. largen_ref — the large-N experiment at N = 2048 on the data and probe
                  draws of the JAX run pinned in
                  tests/fixtures/jax_gibbs_largen_ref.npz: its losses at steps
                  0 and 19 against JAX's, K2's and K3's launch counts (no K9);
 6. largen     — the gate at N = 16384 (20 Adam steps, rank 150, 16 mBCG
                  iterations): relres of the trained-pose solve, the loss
                  against the dense Cholesky oracle, the gradient cosine,
                  K2's and K3's launch counts against what the code implies
                  (no K9: the oracle builds its Gram with the plain Gram),
                  training and wall seconds;
 7. k2         — K2 against its plain version (the band K2_RTOL / K2_ATOL)
                  and against float64 (within twice the plain version's error
                  plus K6_FLOOR of the largest entry) at (16384, 16384, D = 2,
                  R = 9) on the gate's init-pose and trained-pose payloads and
                  at a ragged (1000, 1500, D = 3, R = 130, the per-dim
                  element), bitwise repeat, then the median time of each, the
                  FP32 bound of the recounted operations and the
                  special-function-unit bound (2 an element at 16 a clock an
                  SM at nvidia-smi's maximum SM clock); the bound is the
                  larger;
 8. k3         — K3 against its plain version (K3_TOL) and against float64
                  (K2's criterion) at N = 16384, R = 8 on the same payloads,
                  its row-block form on one block and a ragged row form
                  (1000 of 1500 rows, D = 3, the per-dim element, R = 5),
                  bitwise repeat; times, the FP32 bound of the recounted
                  operations (beside the per-dim count's) and the
                  special-function-unit bound; the bound is the larger;
 9. dgp_ref    — the deep GP on the card at full width (M = 250) for 2
                  splits and 10 steps, from the init, batch schedule and ε
                  of the JAX run pinned in tests/fixtures/jax_deepgp_ref.npz:
                  its losses at steps 0 and 9 against JAX's, each K_zz
                  member's jitter at init against the pinned run's, one K4
                  call and one K7 forward and backward per step;
10. dgp        — the whole experiment (10 splits, 400 steps, M = 250):
                  RMSE/NLPD against the deepgp_spatial_10split band, K4's
                  and K7's launch counts against what the code implies,
                  steps/s;
11. k4         — K4 against its plain version on the experiment's init and
                  trained payloads (50 × M = 250, D = 2, P = 501) and a
                  ragged (3, 37, D = 3), each held to float64 as in
                  tests/test_torch_svgp_precompute.py, K4's L⁻¹ residual
                  and W to entrywise γ_M bounds, and L's backward error to
                  γ_(M+1)|L||Lᵀ|; the retry case (a duplicated z at s² =
                  40) beside a healthy member; its cluster size, shared
                  memory and co-resident clusters; times beside the
                  two-launch design's it replaced;
12. k10b       — K10b (the retry-free grid-batched (L, L⁻¹)) and its plain
                  version against float64 on the deep GP's K_zz stacks at
                  init and trained (50 × 250²), the slice's Gram (10 × 316²),
                  (3, 512) and a ragged (2, 130); a non-PD member beside
                  healthy ones; bitwise repeat; bitwise equal to K1 with its
                  retry off on the K_zz and slice stacks; its entry
                  chol_inv_batched forward and backward, counted; times at
                  (50, 250), (10, 316) and (3, 512);
13. k7         — K7's forward and backward, and the plain version in f32,
                  against the plain version in float64 on the experiment's
                  init and trained payloads (10 splits, B 315, S 3, M 250),
                  a ragged (3, 37, 2, 19) and one whose variances hit the
                  1e-10 floor; on each, the forward's per-row mean and
                  variance (elbo_fused.forward_moments) against the
                  backward's recomputed ones (backward_moments), to the bit;
                  bitwise repeat; the times of the kernels, the plain
                  version, and the fused term against the composed data term
                  through autograd;
14. field_regression — the whole experiment (spatial DeepGP, 400 steps,
                  and the spatio-temporal one, 200 steps): the spatial field
                  against the reference artifact inside the
                  dgp_field_regression band, K7 launched once forward and
                  once backward per spatial step, K4 once per step and
                  predict of either half;
15. k5         — K5, its plain version and torch.linalg.cholesky against
                  float64 on the dense run's N = 8192 Gram at init and a
                  ragged N = 6500 SPD matrix (padded to 6656), K5's backward
                  error against γ_(N+1)|L||Lᵀ|, bitwise repeat; a rank-30
                  matrix through safe_cholesky's retry; times of all three;
16. k10c       — K10c (the v1 streaming Cholesky, on K5's right-looking
                  factorisation), its plain version, K5 and
                  torch.linalg.cholesky against float64 on the dense run's
                  Grams at N = 8192 and 4096 and a ragged N = 1000 (K5's
                  criterion, the backward error included), bitwise repeat; a
                  rank-30 matrix non-finite; its entry streaming_cholesky_v1
                  forward and backward, counted; times of all four at 8192
                  and 4096;
17. exact_dense — bench_scaling.py's exact loop (N = 1024..8192, 20 Adam
                  steps each): K5 called exactly once per step at N = 8192,
                  K10a once per step at N = 1024, and no other kernel, the N = 8192 losses at steps 0 and 19
                  against the same loop with the plain version in K5's
                  place, ms/step at every N;
18. seard_ref  — 2 splits × 51 steps of the seard fit against the JAX run
                  pinned in tests/fixtures/jax_exact_ref.npz (steps 0, 50);
19. seard      — the whole experiment (10 splits, 400 steps) inside the
                  seard_spatial_10split band, no kernel launched;
20. temporal   — the whole experiment (2000 steps) inside the temporal
                  band, no kernel launched;
21. exact_lazy_ref — the matrix-free ExactGP at N = 2048 on the pinned JAX
                  run's data and probe draws: its losses at steps 0 and 19;
22. exact_lazy — the matrix-free gate at N = 16384 (20 steps, rank 150, 32
                  mBCG iterations): relres, the loss against the float64
                  Cholesky oracle, the gradient cosine (lengthscale,
                  outputscale and noise gradients non-zero), the predictive
                  mean at 64 points against the dense posterior's, K6's
                  launch count against what the code implies;
23. k6         — K6 and its plain version against float64 on the gate's
                  trained payload (16384², R = 9) and a column-chunked
                  (2048 × 16384, R = 200), bitwise repeat; times, the FP32
                  bound and the special-function-unit bound (1 an element),
                  the larger its bound;
24. gibbs_dense_ref — the Gibbs row at N = 1024 from the init of the JAX run
                  pinned in tests/fixtures/jax_gibbs_dense_ref.npz: its losses
                  at steps 0 and 19 against JAX's, then the predictive mean
                  and variance at the pinned trained pose against JAX's;
25. gibbs_dense — bench_scaling.py's Gibbs rows (N = 1024 and 1280, 20 Adam
                  steps each) and their predictive at a 16 × 16 grid: per N,
                  K8 once per step, K9 three times, K10a and K11 once each,
                  and no other kernel; ms/step, RMSE and NLPD; then the
                  trained predictive's time and K11's span on the device in it;
26. k9         — K9 and its plain version against float64 on the
                  predictive's three Grams at the rows' init and trained
                  poses and a ragged N = 1000, on the slice's field
                  prediction's three Grams (316², 394², 394 × 316) at
                  two ℓ fields, and on a random D = 3 pair, bitwise
                  repeat; at D = 2 its first 9 columns bitwise equal to
                  K2's product with I[:, :9]; the stacked entry on the
                  paths' stacks ((10, 316²), (10, 316 × 250), (10, 250²))
                  and the ST model's 172 × 100 and 215 × 100 pairs, one
                  launch a call, each member bit for bit the 2-D launch on
                  it, against float64; times (CUDA events around blocks of
                  calls), the stacked (10, 316 × 250) beside its plain
                  version;
27. k10a       — K10a, its plain version and torch.linalg.cholesky against
                  float64 on the predictive's noisy Gram at the same poses
                  (K5's criterion, the backward error included), bitwise
                  repeat; a rank-30 matrix through safe_cholesky's retry;
                  times;
28. k11        — K11 and its plain version against float64 on L⁻¹K_xs (K =
                  256) and on K = 70 at the same poses, bitwise repeat, the
                  backward-error ratio |LX − B| / γ_(N+1)|L||X| of K11 and of
                  solve_triangular; times at K = 256 and 70, and the CUDA
                  launches of one call (torch.profiler);
29. k8         — K8 and its plain version against float64 on the MAP loss's
                  payloads at the same poses, L's backward error within
                  γ_(N+1)|L||Lᵀ| (K10a's bound); a singular payload on
                  which the jitter ladder fires, on the plain version's
                  rung; bitwise repeat; times at N = 1024 and 1280, the
                  CUDA launches of one call (3·N_pad/128 an attempt) and
                  the device span of the happy path's empty attempts;
30. traced     — torch.profiler after the paths' own traces: K1's, K2's,
                  K3's, K4's, K6's, K9's (2-D and stacked) and K10b's CUDA
                  launches in one call (every device kernel, checked 1, 2,
                  2, 1, 2, 1, 1 and 1), K7's
                  forward's (checked 10), K7's forward and backward time by
                  kernel, and K9's device time (the median of 60 launches'
                  durations at 1280²);
30b. k12       — K12 (the prior's SE-ARD Gram·V in float64) against its plain
                  version (the prior's float64 panels) on the quickstart's
                  data at the prior's pose: 16384², R 1 and R 16 with the
                  1e-4 jitter, a ragged 4096 × 16391, R 2; each entry within
                  2(N + 64)·ε₆₄ of Σⱼ |K_ij||V_j|, bitwise repeat; its exp
                  probe against torch.exp and exp's FP64 operations counted
                  in the library's SASS (cuobjdump) against the bound's
                  constant; times and the FP64 bound (34 TFLOP/s);
31. gibbs_mf_ref — the matrix-free Gibbs flow of examples/
                  quickstart_gibbs_largen.py at N = 2048 on the data, prior
                  SLQ probes and per-step probes of the JAX run pinned in
                  tests/fixtures/jax_gibbs_mf_ref.npz: the prior's SLQ
                  logdet against the float64 dense one, its losses at steps
                  0 and 19 against JAX's (the prior's logdet the pinned one),
                  the posterior at the pinned trained pose against the
                  float64 dense posterior, K2's, K3's and K12's launches
                  (K12 once an iteration of each prior solve, none stopped
                  early, and once a dim a conditional mean);
32. gibbs_mf    — the same flow at N = 16384 (20 steps, data rank 150, prior
                  rank 50, 8 probes, block 2048): the matrix-free loss against
                  the dense MAP loss, prior included, the gradient cosine, the
                  field's gradient term by term against float64 (the prior's
                  against the exact one, the data term's against the same
                  probes' estimator with exact solves), the trained-pose relres, the state's mean-only query against the
                  one-shot posterior mean, a finite RMSE, K2's, K3's and
                  K12's launches against what the code implies (K9 once, in
                  the dense oracle); ms a step, the prior's share, the
                  hoist, the state and a query batch;
33. sparse_ref  — the sparse Gibbs slice (10 splits, M = 250), the ST
                  nonstationary model (M = 100) and SGPR (M = 1900) for 20
                  steps from the z of the JAX runs pinned in
                  tests/fixtures/jax_sparse_ref.npz: losses at steps 0 and
                  19 against JAX's (the sparse Gibbs slice's step 19 against
                  its pinned float64 run, within twice JAX's float32
                  distance from it), K9 2 / 1 / 0 a step;
34. gibbs_sparse — spatial_gibbs --inference sparse (2000 steps, 10 splits):
                  the gibbs_spatial_sparse_10split band, K9 twice a step
                  plus 4 in the evaluation and 4 in the field, no other
                  kernel;
35. spatio_temporal — the three spatio_temporal_* rows (the exact baseline,
                  200 steps; Stationary and Non-Stationary at 500 steps, M =
                  100) in their bands, K9 only in the nonstationary run;
36. sgpr        — sgpr_bench at 100 and 1000 iterations in their bands, K10a
                  only in the predictive's NLPD;
37. st_dgp      — spatiotemporal_dgp (200 steps, D = 3): its band, K4 once a
                  step and once in predict, K7 never;
38. serve_ref   — the serving CLI (``serve.run``) for each of its eight
                  families and the matrix-free path at N = 256 and 2048 from
                  the init and draws of the JAX serves pinned in
                  tests/fixtures/jax_serve_ref.npz, at their tiny budgets:
                  the step-0 and last losses against JAX's, the step-0 loss in
                  float64 against JAX's float64, the served mean and σ at
                  JAX's fitted pose (its leaves as a port checkpoint, served
                  with --checkpoint) within twice JAX's own float32 distance
                  from its float64 serve, the matrix-free solves' relres, and
                  every run's launches against what the code implies
                  (``serve_launches``);
39. serve       — ``python -m nonstationary_precip_tpu_torch serve`` for every
                  family at the bundled data's full size and the CLI's default
                  budget with --save_checkpoint, then the CLI's entry from the
                  checkpoint: launches against ``serve_launches``, finite CSVs
                  of (N, d + 2), the restored predictions and CSV bit for bit
                  the fitted run's, fit seconds and steps/s (CUDA events),
                  serve seconds, back-offs and the hindcast RMSE;
40. chunked_ref — the host-chunked surface (``make_chunked_map_loss``,
                  ``fit_chunked``, the chunked serving state) on the data of
                  examples/quickstart_gibbs_chunked.py at N = 384 and 2048
                  against the JAX runs pinned in
                  tests/fixtures/jax_chunked_ref.npz: the step-0 loss and
                  gradients under greedy pivots and stride Nyström (at 384
                  also keyed Nyström and RPCholesky, JAX's landmarks and
                  Gumbel draws passed in), five Adam steps, the state's α
                  relres and its mean-only query, float32 through K2 and
                  K3; the 384 step-0 cases in float64 at 1e-10;
41. chunked     — the JAX package's flagship large-N serving CLI
                  (--matrixfree --chunked, Nyström rank 1024, shift 10) at
                  N = 16384: its steps and a 4096-point query with
                  variances, the step-0 chunked loss and gradient against
                  the monolithic loss_matrixfree with the same factor and
                  draws, each solve's relres and the Nyström directions kept
                  (readings), K2's and K3's launches from the iterations
                  each run reports, K12 from the prior solves' reported
                  iterations, K9 none; then the prior-free chunked loss at
                  N = 131072 with the backward whole and in 2 row blocks
                  (K3's row entry), bit for bit, and the same loss with its
                  prior, hoisted as serve hoists it (K12), every training
                  solve within the relres gate.
42. baselines_ref — the production driver (``experiments.
                  precipitation_baselines``) exact and sparse at the argv of
                  the JAX driver's runs pinned in
                  tests/fixtures/jax_baselines_ref.npz (20 steps, M = 20, the
                  sparse run from JAX's k-means centres): the step-0 loss,
                  the JSONL records' objectives, RMSEs and NLPDs and the run
                  directory against JAX's, the launches
                  (``baselines_launches``: K9 a step and in each predictive
                  where N₁·N₂ ≥ 128²);
43. baselines   — the driver at its defaults (uib_spatial.csv, 2000
                  iterations, log 50, test 200), exact and sparse (M = 250):
                  finite metrics, the JSONL and checkpoints, the launches,
                  seconds and steps/s (CUDA events); then --resume from
                  final/ with --max_iters 0 serves the trained predictive bit
                  for bit;
44. baselines_dense — the driver on a 1280-row CSV (N_train 1025): K8 once a
                  step, each predictive K9 ×3, K10a and K11 once; K8 at the
                  trained pose against its plain version and float64 (k8's
                  criteria);
45. full_cov    — ``DeepGP.loss(full_cov=True)`` at the dgp shapes (B 315,
                  S 3, M 250) for 5 Adam steps: K4 once a step, K7 never;
                  the loss and gradient against float64 on the card;
46. dense_cg    — ``ExactGP.mll`` and ``predictive`` with the dense
                  ``solver='cg'`` at quickstart_cg_largen's N = 1600: the CG
                  MLL within 3σ (the SLQ spread over 8 probe sets) of the
                  Cholesky MLL, float32 against float64 within σ and the
                  gradient spread, the CG mean within 1e-2 of Cholesky's;
47. quickstarts — the five ported examples/quickstart_* (exact_gp,
                  gibbs_spatial, deepgp, cg_largen, lazy_largen) at their
                  defaults with their asserts: K9 in gibbs_spatial, K4 and
                  K7 in deepgp, K6 in lazy_largen, counted;
48. parallel    — ``parallel/`` on a world-1 NCCL group this script starts
                  from a FileStore in a temporary directory (one card;
                  ``--world P`` runs the same ``w_*`` functions on P
                  cards), the nine paths of JAX's ``dryrun_multichip``, each
                  also run without a mesh in float32 and float64 and held
                  by ``hold_path``: data-parallel DSVI at bench.py's shapes
                  for 3 Adam steps (K4 and K7 once each way a step), the
                  sharded marginals over the 394 sites (K9),
                  fit_splits(mesh=) on 8 splits of the slice for 50 steps
                  and eval_splits(mesh=) (K1 and K9 once a step), and at the
                  gate's trained pose (N = 16384, rank 150, 16 iterations)
                  sharded_cg_mll with packed_gibbs_local_matvec(2) (K2 once
                  an iteration, no K3), its default path at N = 4096 (no
                  kernel), make_sharded_chunked_mll and the sharded
                  posterior state and a 512-point query with the Nyström
                  factor (rank 1024, shift 10), each bit for bit one
                  device's; the row-sharded SGPR by JAX's dryrun criterion;
                  the sharded sparse Gibbs bound on the slice's 316 rows at
                  M = 250, both scale_corrections (K9), in float32 as near
                  float64 as one device's; the sparse bound and the CG paths
                  also in float64, within PAR_SPARSE_F64 and PAR_CG_F64 of
                  one device's float64; the 1-D and the 2-D (1 × 1) sharded
                  Cholesky at 8192² and 4096², block 256, by K5's criteria
                  beside potrf, timed, and both on F-P8's ill-conditioned
                  1024² input (``fp8_input``) at jitters 1e-4 and 2e-5 by the
                  same criteria;
49. k2_rows     — K2 on the four (N/4, N) row blocks of N = 16384 (each
                  rank's product in a 4-card run) against its plain version
                  and float64, their concatenation against the whole launch
                  (bit for bit or not, reported), one block timed beside its
                  plain version and its bound;
50. parallel_examples — examples/quickstart_dataparallel and
                  quickstart_sharded_largen (also --gibbs) at their defaults
                  on a world-1 NCCL group, and mv_gibbs_demo and
                  matrix_normal_demo, each ending in "ok" (no figure without
                  matplotlib, said once), counted: K4 and K7, none, K2, K10a
                  and K11.
Each of the last eighteen phases prints its seconds.  After k3 come k2_modes
(K2's 'default' and 'high3' tensor-core kernels against their plain
versions and float64 within bf16's bound on the gate's trained payload and a
ragged 1000 × 1300, 'default' against its plain version within MODE_TIGHT of
the plain version's float64 error, both modes' bias on a V built to show it
(MODE_BIAS), 'vpu' as the 'highest' walk refusing R = 33, each
mode's times and bounds, one gate step under each mode: 'high3' in the
gate's relres and loss bands, 'default''s relres a reading) and after k6
k6_modes (K6's, with a 16-iteration solve through ``make_rbf_matvec`` under
each mode).

Any failed check raises, and the script exits non-zero without printing a
result.  The last lines are nvidia-smi's line, the kernels' JSON line (K1's,
K2's, K3's, K4's, K2's and K6's mode kernels', K6's, K7's, K5's, K10c's,
K10a's, K11's, K8's and K12's entries
with the registers, spills and shared memory of each of their kernels, K1's
and K4's with their cluster size) and the result line.  Needs a CUDA card and nvcc; imports no
JAX.

With ``--world P`` the script runs ``parallel/`` on P cards of one host
instead, one NCCL rank a card (``parallel.launch.start``; P = 1 rehearses
the multi-card run on one card), and raises where the host has fewer than P
cards.  It builds every kernel once in this process, makes the gate's
trained pose on card 0, then each rank (``world_rank``) drives, at JAX's
P-scaled ``dryrun_multichip`` sizes (WORLD_SPLITS, WORLD_SGPR_ROWS): DP
DSVI (B = 315 a shard, M = 250, S = 3, 3 steps; K4, K7), the row-sharded
SGPR, the sharded sparse Gibbs bound (K9), the sharded marginals (K9), the
1-D sharded Cholesky at 8192² and the 2-D one at 4096² on a (P/2, 2) mesh,
each also on F-P8's input, fit_splits/eval_splits(mesh=) on 8 splits (K1,
K9), at the gate's pose the sharded CG MLL, its default path, its chunked
entry and the Nyström state and query (K2 on each rank's (N/P, N) row
block), the sparse bound and the CG paths also in float64, one mBCG
iteration's K2 and NCCL all_gather timed (the tiled wrapper and
``all_gather_into_tensor``), and the two parallel quickstarts at their
defaults (K4, K7; K2 with --gibbs).  This process then runs each path's
one-device counterpart on card 0 in float32 and float64 and holds every
rank (``hold_path``): each float32 result the same on every rank and
within WORLD_GAP times the one-device float32 gap to float64, each float64
run within PAR_SPARSE_F64 or PAR_CG_F64 of one device's float64; each
Cholesky by K5's criteria on rank 0; every rank's launches
(``world_launches``).  Beside fit_splits, ``fit_splits_batch_probe``
reports which batched op makes P ranks part from one card.  Lines: device, build,
gate_pose, a ``parallel`` line a path (per-rank launches, errors, seconds
at P beside one card's), ``parallel_examples``, ``kernels`` (every rank's
launches), nvidia-smi's line, the result line.  A rank that fails ends
the run with its log and a non-zero exit; every rank is killed past
WORLD_DEADLINE.

With ``--octave N`` the script runs the JAX package's N = 1,048,576 flagship
configuration at N rows instead, on K2, K3 and K12 (two nvcc runs): (i)
the prior-free host-chunked MLL of tools/probe_chunked.py (its recorded
row, chunked-lazygnys-r1024-i32x8-s10-1048576: Nyström rank 1024, shift
10, 4 × 8 chunks, 3 Adam steps), every training solve within the relres
gate, the kept directions, the state's α relres along the shift ladder,
the held-out RMSE against the predict-zero baseline's; (ii) ``serve
--matrixfree --chunked --precond nystrom --precond_rank 1024
--precond_shift 10`` with its prior on the same data, 3 Adam steps, 128
query points with variances: every solve's relres and iterations, the hoist's, fit's and
serve's seconds, the launches, the training solves within the gate, no
panel built on the card.

Run from the repository root: python3 chip_smoke.py [--steps N] [--world P]
[--octave N]
"""

from __future__ import annotations

import argparse
import contextlib
import copy
import io
import json
import os
import re
import statistics
import subprocess
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

# K1 against its plain version on the card, both float32 (ops/chol_inv.py
# and tests/test_torch_chol_inv.py state the reasons): L within 5e-6 of the
# float64 factor relative to its largest entry, ‖L⁻¹L − I‖∞ ≤ 5e-5, kernel
# and plain within 1e-5 relative of each other.
TOL_L_F64 = 5e-6
TOL_LINV_RESIDUAL = 5e-5
TOL_KERNEL_PLAIN = 1e-5
# The slice against the pinned JAX float32 losses (the same tolerances as
# tests/test_torch_jax_reference.py, which explains them).
RTOL_STEP0 = 1e-4
RTOL_STEP50 = 1e-2
N_TIMED = 60  # calls per timed block; blocks run plain, kernel, kernel, plain
# K2 against its plain version (tests/test_torch_matvec.py's band, from the
# JAX kernel's own tests): both are f32 sums of N terms in another order.
K2_RTOL, K2_ATOL = 2e-5, 2e-4
# K3 against its plain version, relative to each output's largest entry: its
# outputs are signed sums of N products with cancellation, so an entrywise
# relative band means nothing near zero.  Measured 1.6e-6 on random factors
# at N = 16384; 2e-5 leaves a tenfold margin.
K3_TOL = 2e-5
# The large-N run at N = 2048 against the pinned JAX float32 losses: at
# step 0 both compute the same estimator on the same probes in another
# summation order (the port's CPU run: 6e-6); Adam's first steps are
# ~lr·sign(g), so per-point lengthscales whose gradient is near zero move
# apart and by step 19 the loss follows (the port's CPU run: 6.0e-3).
LARGEN_RTOL_STEP0 = 1e-3
LARGEN_RTOL_STEP19 = 1e-2
# The RESULTS gate (run_benchmarks.py), hardware-independent.
GATE_RELRES, GATE_LOSS_REL, GATE_COSINE = 1e-2, 5e-2, 0.98
LARGEN_N = 16384
LARGEN_REF = Path(__file__).resolve().parent / "tests" / "fixtures" / "jax_gibbs_largen_ref.npz"
RAGGED = (1000, 1500, 3, 130)  # K2's ragged shape: R crosses the 128-column seam
K3_ROWS = (2048, 4096)  # the row block of K3's row form
K3_RAGGED = (1000, 1500, 3, 5)  # K3's ragged row form: rows, columns, D (the per-dim element), R
N_TIMED_GRAM = 20  # calls per timed block at N = 16384 (the plain version takes ~40 ms)
# The deep GP against the pinned JAX float32 losses: at step 0 both compute
# the same ELBO from the same init and ε (the port's CPU run: 6e-8); Adam's
# first steps are ~lr·sign(g), so parameters whose gradient is near zero move
# apart, and by step 9 the loss follows (the port's CPU run: 2.4e-3).
DGP_RTOL_STEP0 = 1e-4
DGP_RTOL_STEP9 = 1e-2
DGP_REF = Path(__file__).resolve().parent / "tests" / "fixtures" / "jax_deepgp_ref.npz"
# The RESULTS band of deepgp_spatial_10split (run_benchmarks.py:29),
# hardware-independent.
DGP_RMSE, DGP_NLPD = 0.48, 0.70
# K4 against float64, as tests/test_torch_svgp_precompute.py and
# tests/test_pallas.py:352-369 hold a kernel: the K_zz of 250 inducing points
# in 2-D is near-singular (‖L⁻¹‖ ~ 3e2), so each f32 output's error from
# float64 must stay within twice the plain f32 version's own, plus a floor
# of 1e-5 in L and 1e-3 in W and L⁻¹.
K4_SLACK = {"L": 1e-5, "W": 1e-3, "Linv": 1e-3}
# Beside that, two bounds on K4's own f32 arithmetic that do not depend on
# the conditioning (Higham, Accuracy and Stability of Numerical Algorithms,
# §3.1 and §8.1), with γ_M = M·u/(1 − M·u), u = 2⁻²⁴: the sweep forms each
# column of L⁻¹ by forward substitution in the kernel's own L, so
# |L·L⁻¹ − I| ≤ γ_M·|L|·|L⁻¹| entrywise; the W kernel sums at most M products
# per entry, so |W − (L⁻¹)ᵀP| ≤ γ_M·|L⁻¹|ᵀ|P| with the kernel's own L⁻¹.
# Each error over its bound, computed in float64, must be at most 1.
K4_RAGGED = (3, 37, 3)
# the retried member: L Lᵀ reconstructs K + jitter·I to 5e-2 at s² = 40
# (tests/test_pallas.py:449's band)
K4_RETRY_RECON = 5e-2
# The design K4's cluster kernel replaced (a 1024-thread block a member on
# the column sweep, then a W kernel), at (50, 250, D 2, P 501) on an NVIDIA
# H100 80GB HBM3 at 700 W: its median time on the trained payload in this
# script's k4 phase, 0.699-0.728 ms (PERF.md §6, PRs 4, 5 and 12), 0.518 ms
# of it the factor and 0.181 the W kernel (tools/profile_torch_dgp.py, PR 12),
# 2 CUDA launches a call.  Printed beside the kernel's own time; no check
# rests on it.
K4_BEFORE = {"ms": 0.70, "factor_ms": 0.518, "w_ms": 0.181, "cuda_launches_a_call": 2}
# K7 against float64: the value and every cotangent of the kernel within
# twice the plain f32 version's error (relative to the largest float64
# entry) plus a slack of 1e-6 for the value and 1e-4 for the cotangents:
# both sum in f32 through a chain of exps, in other orders (on the TPU the
# Pallas backward differed from the plain one by up to 2.3e-4 of the
# largest entry in interpret mode).
K7_SLACK = {"value": 1e-6, "cotangent": 1e-4}
# Errors are relative to the largest float64 entry, or to K7_FLOOR where that
# is smaller: at the deep GP's init (q(u) = N(0, I)) the z, ℓ and mean-weight
# cotangents vanish in exact arithmetic (the two halves of outbar·Wᵀ cancel),
# and what both f32 versions return there is rounding.
K7_FLOOR = 1e-6
# K7's forward kernels (elbo_k_kernel and elbo_out_kernel three launches a
# call, one a layer, the others one) and backward kernels (elbo_bwd_pull_kernel
# three, the others one); the marginals' two kernels are both passes'
K7_FWD_KERNELS = ("elbo_k_kernel", "elbo_out_kernel", "elbo_fwd_layer1_kernel", "elbo_fwd_layer2_kernel",
                  "elbo_fwd_head_kernel", "elbo_sum_kernel")
K7_BWD_KERNELS = ("elbo_k_kernel", "elbo_out_kernel", "elbo_bwd_head_kernel", "elbo_bwd_pull_kernel",
                  "elbo_bwd_layer2_kernel", "elbo_bwd_layer1_kernel", "elbo_wbar_kernel", "elbo_bwd_reduce_kernel")
K7_RAGGED = (3, 37, 2, 19)  # T, B, S, M: a ragged tile and chunk, M not a multiple of 32
K7_CLIP = (2, 50, 3, 32)
# The RESULTS band of dgp_field_regression (run_benchmarks.py:37),
# hardware-independent: RMSE between the fields and 1 − their correlation.
FIELD_RMSE, FIELD_1MCORR = 0.60, 0.10
# K5 against float64, as tests/test_pallas.py holds the JAX kernel: its
# factor's largest error must stay within twice torch.linalg.cholesky's own
# (cuSOLVER potrf, f32) plus a floor of 1e-6 of the largest entry; and its
# own backward error within Higham's Theorem 10.3 bound, entrywise
# |L·Lᵀ − A| ≤ γ_{N+1}·|L|·|Lᵀ| + (N + 1)·2⁻¹⁴⁹, γ_n = n·u/(1 − n·u),
# u = 2⁻²⁴, ratio ≤ 1 (the last term is gradual underflow's; see chol_errors).
K5_FLOOR = 1e-6
K5_N, K5_RAGGED = 8192, 6500  # the dense run's N; a size that pads to 6656
K5_TIMED = 20  # calls per timed block (K5 takes tens of ms)
EXACT_REF = Path(__file__).resolve().parent / "tests" / "fixtures" / "jax_exact_ref.npz"
# The dense loop at N = 8192 with K5 against the same loop with the plain
# version in its place: both factor the same matrices in f32 and differ in
# rounding only (the port's CPU runs agree to ~1e-6), so the step-0 losses
# agree to 1e-4; Adam's sign-like first steps let the traces drift, so
# step 19 to 1e-3.
DENSE_RTOL_STEP0, DENSE_RTOL_STEP19 = 1e-4, 1e-3
# seard against the pinned JAX float32 losses: step 0 is the same MLL in
# another summation order; by step 50 Adam's trajectories drift apart
# (the tolerances of the slice's, tests/test_torch_jax_reference.py).
SEARD_RTOL_STEP0, SEARD_RTOL_STEP50 = 1e-4, 1e-2
# The RESULTS bands (run_benchmarks.py:22-23), hardware-independent.
SEARD_RMSE, SEARD_NLPD = 0.42, 0.55
TEMPORAL_RMSE, TEMPORAL_NLPD = 0.82, 1.35
# The matrix-free ExactGP at N = 2048 against the pinned JAX run: step 0 is
# the same estimator on the same probes (the port's CPU run: 0.0); by step
# 19 Adam's trajectories drift (the port's CPU run: 1.9e-5).
LAZY_RTOL_STEP0, LAZY_RTOL_STEP19 = 1e-3, 1e-2
# The matrix-free predictive mean at the quickstart's 64 test points
# against the dense posterior's (examples/quickstart_lazy_largen.py's band).
LAZY_MEAN_TOL = 1e-2
# K6 against float64: its error must stay within twice the plain version's
# (which forms the quadratic from the identity with its clamp, K6 from the
# differences; both sum N products in f32) plus 1e-6 of the largest entry.
K6_FLOOR = 1e-6
K6_WIDE = (2048, 200)  # rows and right-hand sides of the column-chunked case
# The dense Gibbs rows of bench_scaling.py (experiments/exact_largen.gibbs_dense)
# and their kernels' ragged size: in K8's, K10a's and K11's windows, padded
# (to 1024) by each; K11 also at the JAX tests' ragged K = 70.
GIBBS_NS = (1024, 1280)
GIBBS_RAGGED = 1000
K11_WIDTHS = (256, 70)  # the predictive's right-hand sides (the 16 × 16 grid), and 70
GIBBS_REF = Path(__file__).resolve().parent / "tests" / "fixtures" / "jax_gibbs_dense_ref.npz"
# The Gibbs row at N = 1024 from the pinned JAX run's init against its losses:
# step 0 is the same MAP loss summed in another order (the port's CPU f32
# run: 7.4e-6); Adam's sign-like first steps let the traces drift (CPU, step
# 19: 9.0e-6).
GIBBS_RTOL_STEP0, GIBBS_RTOL_STEP19 = 1e-4, 1e-2
# The predictive at the pinned trained pose against JAX's, both f32: the
# mean within 1e-3 absolute (its entries reach 1.03; the port's CPU run:
# 2.3e-4); the variance within 5e-4 absolute: it is k_ss − vᵀv + 1e-4 + σ²,
# two terms of size s² = 0.644 that cancel to ~0.012, so its f32 error is
# absolute at the scale of s² (the port's CPU run: 7.4e-5).  The card sums
# through K9, K10a and K11 in other orders than either CPU run.
GIBBS_MEAN_ATOL, GIBBS_VAR_ATOL = 1e-3, 5e-4
# K9, K10a and K11 against float64, K5's criterion: the kernel's error within
# twice the plain f32 version's plus 1e-6 of the largest float64 entry: each
# sums in f32 in another order than its plain version (torch's elementwise
# ops, cuSOLVER potrf, cuBLAS trsm).
DENSE_FLOOR = 1e-6
# K9's own cases beside the predictive's Grams: random pairs (x in [-2, 2],
# ℓ = exp(0.3·N(0, 1))) of (rows, columns) at D = 3 (the per-dim element)
# and at D = 2 (257 columns: a float at a time); the slice's field
# prediction's three Grams (train 316² and 394 × 316: float4 stores; all
# sites 394²: float2, which no other case runs at D = 2) on its last
# split's sites, at their init ℓ and at ℓ = exp(0.3·N(0, 1)); at D = 2 its
# first 9 columns (mBCG's 1 + 8 probes) against K2's.
K9_D3, K9_D2_RAGGED, K9_ONE_HOT = (257, 394), (130, 257), 9
# K9's stacked entry (F-P5): a stack of pairs with one leading shape is one
# launch, a member on the grid's third axis, as Pallas's vmap batching runs
# the TPU kernel.  Held at the paths' stacks (the slice's (10, 316²), the
# sparse Gibbs model's (10, 316 × 250) and (10, 250²)) and the ST model's
# 2-D pairs (172 × 100 in its step, 215 × 100 in its field): each member
# bit for bit the 2-D launch on it, float64 by check_f64 with DENSE_FLOOR.
K9_STACK_TIMED = "sparse_316x250"

# The quality bands of the sparse and spatio-temporal rows
# (run_benchmarks.py:24-32, RMSE and NLPD ceilings).
BANDS = {"gibbs_spatial_sparse_10split": (0.31, 0.15), "spatio_temporal_stationary_exact": (2.25, 3.9),
         "spatio_temporal_stationary": (2.55, 4.3), "spatio_temporal_nonstationary": (2.45, 5.6),
         "spatiotemporal_dgp": (1.80, 2.40), "sgpr_bench_100iter": (1.70, 2.10),
         "sgpr_bench_converged": (1.70, 2.10)}
# Their run_benchmarks.py arguments.
SPARSE_STEPS = 2000  # spatial_gibbs --inference sparse --max_iters 2000
ST_STEPS = 500  # spatio_temporal --max_iters 500 (both models); --num_inducing 100 for the nonstationary
ST_INDUCING = 100
SGPR_ITERS = (100, 1000)
# The pinned float32 JAX runs of the three sparse models (20 Adam steps from
# JAX's z): tests/fixtures/jax_sparse_ref.npz, tools/pin_jax_sparse.py.
SPARSE_REF = Path(__file__).resolve().parent / "tests" / "fixtures" / "jax_sparse_ref.npz"
# Step 0 of the sparse Gibbs slice: its float32 loss sits 1.7e-3–4.0e-3
# from float64 in JAX and in the port alike (K_zz of 250 k-means centres
# takes safe_cholesky's first jitter rung), and the two sit up to 1.5e-4
# apart on the CPU (tests/test_torch_sparse_gp.py, RTOL_STEP0_GIBBS); the
# ST model and SGPR agree to 2e-6 there and keep RTOL_STEP0.  Its step 19:
# the gradient in z passes through that K_zz, so float32 trajectories part
# from float64 within 20 steps (JAX's by up to 18 % of the largest split's
# loss on the CPU, the port's alike): each split's step-19 loss is held to
# the pinned float64 run within twice JAX's float32 distance from it, plus
# RTOL_STEP50.  The ST model and SGPR keep RTOL_STEP50 (on the CPU the port
# is within 1.6e-4 and 1.7e-6 of JAX there).
RTOL_STEP0_SPARSE_GIBBS = 5e-4
# Checks of the sparse Gibbs slice that its float32 drift cannot pass
# (tools/witness_sparse.py --only gibbs): both packages take the same
# jitter on K_zz at every step (1e-5 in float32, none in float64), and
# the float32 runs part from JAX's by 1e-2 within 5-9 steps with z
# training or frozen (the field's float32 gradient carries 9-20 % of
# rounding in either package).  Each split's step-0 gradient, relative in
# norm to JAX's: in float32 the gradient in z within 5e-2 (measured 2.74e-2
# on the card, 2.5e-2-2.8e-2 on the CPU; float32 against float64 differs
# by 63-450 %, a wrong path by O(1)); the field's is reported only; in
# float64 z within 1e-4 and the field within 1e-5 (card 3.5e-6 and 8.0e-8).
# With z frozen, 20 float64 steps follow JAX's float64 run (card 5.4e-11
# at step 0, 4.9e-9 at step 19; with z training the float64 runs part
# too, by 1e-6 at step 12 and 9e-3 at step 19).
SPARSE_GRAD_RTOL = {torch.float32: {"z": 5e-2}, torch.float64: {"z": 1e-4, "log_ell_z": 1e-5}}
SPARSE_F64_RTOL = (1e-8, 1e-6)
# K9's device time in `traced`: the median of this many launches' durations
# at 1280² (the CUDA-event time around blocks of calls is what a caller
# pays, host included).
K9_TRACED = 60
# K8 against float64: L within twice the plain version's error plus 1e-5 of
# the largest entry, α plus 1e-4: the factorisation sums each 128-tile's
# Schur complement in another order than potrf, on a Gram whose condition
# number reaches ~1e4 (σ² = 0.011), and α passes through an N-step
# substitution (tests/test_pallas.py:176 holds the TPU kernel's α to 5e-3
# absolute).
K8_FLOOR = {"L": 1e-5, "alpha": 1e-4}
# K10b against float64 on the deep GP's K_zz stacks, the slice's Gram and
# random SPD stacks: each output within twice the plain f32 version's error
# (both relative to the largest float64 entry) plus a floor: 1e-5 in L
# everywhere; in L⁻¹ K4's 1e-3 on the K_zz stacks (250 inducing points make
# K_zz near-singular, so L⁻¹ carries f32 error that grows with its condition
# in both versions: 4.3e-2–5.7e-2 measured) and 1e-5 on the slice's Gram
# (measured: L 4.8e-6, L⁻¹ 3.2e-5, plain 3.9e-6 / 2.8e-5) and the random
# stacks (≤ 4.7e-7 in both versions).  Neither
# version retries, so a member that is singular to f32 working accuracy may
# come out non-finite from either (``k10b_errors``).
K10B_FLOOR = {"L": 1e-5, "Linv": 1e-5, "Linv_kzz": 1e-3}
K10B_RANDOM = ((3, 512), (2, 130))  # the window's top; a ragged N that pads to 160
# K10b is K1's kernel with its retry off: the stacks held bitwise to K1's
# wrapper at max_tries = 0 (N ≤ 384, K1's window).
K10B_AS_K1 = ("kzz_init", "kzz_trained", "slice")
# K10c against float64, K5's criterion (K5_FLOOR, Higham's bound), at the
# dense run's Grams at N = 8192 and 4096 and a ragged N = 1000.
K10C_NS, K10C_RAGGED = (8192, 4096), 1000
# The matrix-free Gibbs flow at N = 2048 against the pinned JAX run
# (tests/fixtures/jax_gibbs_mf_ref.npz).  Its losses with the prior's
# constant logdet taken from the pinned run: at step 0 both compute the
# same estimator on the same probes in another summation order (the port's
# CPU f32 run: 4.0e-7); the data factor is rebuilt at steps 4, 8, 12 and 16
# by greedy pivoting, whose pivot order follows the f32 rounding of the
# residual diagonal, and another factor is another (unbiased) estimator, so
# the traces part there (CPU: 4.5e-4 at step 4, 3.1e-3 at step 19; the JAX
# run's step 13 is NaN, an mBCG breakdown flag the port's run does not
# raise): 1e-2 at step 19, the other large-N runs' final-step band.  The
# posterior at the pinned trained pose is held to the float64 dense
# posterior there (``GibbsExactGP.posterior``), not to the pinned JAX one,
# which is itself 0.110 (mean) and 0.0207 (variance) from it: JAX's float32
# conditioning solves of the lengthscales at the test points (the prior's
# Gram with 1e-4 jitter, 96 iterations to tol 1e-8) move with the rounding,
# where the port runs them in float64 (ROADMAP §3, F6).  The port's mean
# within 1e-4 and its variance within 1e-5 absolute (means reach 1.04,
# variances lie in [0.0024, 0.018]; measured 5.7e-6 and 2.4e-7; the JAX
# run's float32 prior would fail both).  The float64 dense posterior is the
# port's, held to JAX's dense posterior by ``gibbs_dense_ref``.  The
# prior's SLQ logdet is held to the float64 dense logdet within 1e-2 (the
# SLQ estimator's noise at 16 probes; the port's CPU run: 1.5e-4), not to
# JAX's: in float32 its 96 iterations run past convergence and the estimate
# drifts with the rounding (the JAX run: 1658 and −5455 for two dims with
# one Gram, whose float64 logdet is −18325; ROADMAP §3, F5).
GIBBS_MF_REF = Path(__file__).resolve().parent / "tests" / "fixtures" / "jax_gibbs_mf_ref.npz"
GIBBS_MF_RTOL_STEP0, GIBBS_MF_RTOL_STEP19 = 1e-4, 1e-2
GIBBS_MF_MEAN_ATOL, GIBBS_MF_VAR_ATOL, GIBBS_MF_LOGDET_RTOL = 1e-4, 1e-5, 1e-2
# The matrix-free Gibbs flow at the gate's size: data rank 150, prior rank
# 50, 8 probes, block 2048, 20 steps, the factor refreshed every 4; the
# state's mean-only query against the one-shot posterior mean within 1e-3
# (the JAX example's band).
GIBBS_MF_N, GIBBS_MF_STEPS, GIBBS_MF_DRIFT = 16384, 20, 1e-3
# The field's gradient at the trained pose, term by term, against float64
# dense references (``gibbs_mf_field_grads``): cosine and relative error
# ‖g − g_ref‖/‖g_ref‖.  The prior term's is a converged float64 solve with
# no probes, held to the exact gradient of ``prior.log_prob``.  The data
# term's carries the 8 probes' noise, so it is held to the same estimator on
# the same probes with exact solves; what parts them is the f32 mBCG through
# K2 (48 iterations, tol 1e-6) and K3's f32 sums.  Their sum against the
# whole matrix-free field gradient at the gate's cosine.  (Against the exact
# dense gradient, the field's cosine is the estimator's: 0.24 at 8 probes.)
# Measured on an H100: prior 1.4e-7, data 4.2e-4 (cosines 1 − 1e-14 and
# 1 − 9e-8); a factor 2 in the quadratic's pullback or 0.3 for ¼ in K3's
# trace cotangent gives 0.5 and 0.19 (a CPU run at N = 256).
GIBBS_MF_PRIOR_GRAD = {"cosine": 0.99999, "rel": 1e-5}
GIBBS_MF_DATA_GRAD = {"cosine": 0.9999, "rel": 5e-3}
# K12, the prior's SE-ARD Gram·V in float64 (csrc/se_matvec_f64.cu), against
# its plain version (the prior's float64 panels) on the quickstart's data at
# the prior's pose (ℓ 1.5, s² 1): the square operator with the 1e-4 jitter at
# 16384², R 1 (the quadratic's and the conditioning solves') and R 16 (the
# SLQ hoist's probes), and a ragged rectangular 4096 × (16384 + 7), R 2 (the
# conditional mean's cross).  Both are float64 sums of N terms in another
# order, each within γ_N·S of the exact product, S = Σⱼ |K_ij||V_jr| (+ σ²|V_ir|)
# (K ≥ 0, so S is the plain version applied to |V|), with a few roundings of
# the element and exp beside: the two within 2(N + K12_ULPS)·ε₆₄·S entry by
# entry, and the kernel bitwise repeatable.
K12_SHAPES = (("square_r1", 16384, None, 1), ("square_r16", 16384, None, 16), ("ragged_r2", 4096, 16384 + 7, 2))
K12_ULPS = 64
K12_TIMED = 20  # calls per timed block (the plain version takes ~20 ms at 16384²)
K12_WALK = ("se_f64_rows_kernel<2,1>", "se_f64_rows_kernel<2,16>", "se_f64_rows_kernel<2,2>")  # the paths' walks
# The walk's instantiations at the paths' shapes (csrc/gibbs_matvec.cu): K2
# and K6 at D 2, R 9; K3 at D 2 and 1 + 2R = 17 factors.
# The serving CLI.  serve_ref: every family from the pinned JAX
# serve's init and draws (tests/fixtures/jax_serve_ref.npz, made by
# tools/pin_jax_serve.py), as tests/test_torch_serve.py holds it on the CPU:
# the step-0 loss against JAX's float32 one at RTOL_STEP0 (the matrix-free
# cases SERVE_MF_RTOL0: their loss is an SLQ estimate whose prior logdet the
# port takes in float64, JAX in float32, F5/F6; the sparse MV model
# SERVE_MVS_RTOL0: cond(U) ~ 1e7 of its prior lifts float32 rounding to
# 5e-3 in the port's CPU run, 9e-4 in JAX's, so it is held in float64
# instead), the step-0 loss in float64 on the card against JAX's float64 at
# SERVE_F64_RTOL, the last loss at RTOL_STEP50, and the served marginals at
# JAX's fitted pose (its leaves as a port checkpoint, served with
# --checkpoint): from JAX's float64 serve within twice JAX's own float32
# distance from it plus SERVE_F64_FLOOR of the largest value; the deep GP (no
# float64 pin) within SERVE_DGP_RTOL of JAX's float32 serve.  JAX's distance
# is one sample of float32 rounding amplified by the pose's conditioning.
# For the ST nonstationary model (SERVE_REORDERED) that one sample is too
# small to bound another: its Nyström roots factor K_zz of cond 5.4e6
# (spatial) and of numerical rank 10 of 50 (temporal), so the float32
# serve moves with the rounding order.  On an H100 its σ reads 0.00136
# from JAX's float64 serve against twice JAX's gap, 0.00114; with its
# training rows and inducing points in 16 other orders (the same function
# in exact arithmetic), σ reads 0.00026 to 0.00188 on a CPU and 0.00012 to
# 0.00184 on the H100 (tools/probe_serve_f32.py, which also reads models
# 1 % off in one leaf).  So there the sample is widened by the card's own: the port's
# float32 ``_predict`` in SERVE_REORDERS seeded orders against its float64
# ``_predict``, on the card, and the allowance is twice the larger of JAX's
# distance and that spread's largest, plus SERVE_F64_FLOOR of the largest
# value.  The same pose is served in float64 on the card and held to JAX's
# float64 serve at SERVE_POSE_F64 (the sparse MV model SERVE_POSE_F64_MVS:
# cond(U) ~ 1e7 lifts float64 rounding to ~1e-6 in either package).
SERVE_REF = Path(__file__).resolve().parent / "tests" / "fixtures" / "jax_serve_ref.npz"
SERVE_MF_RTOL0, SERVE_MVS_RTOL0, SERVE_F64_RTOL, SERVE_F64_FLOOR, SERVE_DGP_RTOL = 1e-3, 1e-2, 1e-8, 1e-5, 1e-4
SERVE_POSE_F64, SERVE_POSE_F64_MVS = 1e-8, 1e-5
# the leaves that follow the inducing points' order, by family
SERVE_REORDERED, SERVE_REORDERS, SERVE_REORDER_SEED = {"st_nonstationary": ("z", "log_ell_z")}, 16, 17
SERVE_RELRES = 1e-2  # the matrix-free variance solves' gate (serve.RELRES_GATE)
# serve: every family through the CLI at the bundled data's full size and the
# CLI's default budget (1000 Adam steps; the deep GP 400 epochs).
# The sparse MV model diverges at the CLI's defaults (M = 250, lr 0.002) in
# both packages: JAX's own serve on the CPU backs off to lr 0.001
# twice and stops at a non-finite loss, the port's the same on the CPU and
# the card, and the CLI refuses to serve.  ``serve`` checks that refusal at
# the defaults, then serves the family at lr 0.0002, where the port's CPU
# run trains (loss −1.447 → −5.280 over 1000 steps; M = 30, JAX's test
# setting, still diverges on the card at lr 0.002).
SERVE_DIVERGES = {"mv_gibbs_sparse": ("--lr", "0.0002")}
SERVE_SPATIAL = (str(Path(__file__).resolve().parent / "data" / "uib_spatial.csv"),)
SERVE_ST = (str(Path(__file__).resolve().parent / "data" / "uib_spatio_temporal.csv"), "--x_cols", "1,2,3",
            "--y_col", "4")

# The contraction modes of K2 and K6 ('default', 'high3'; tests/
# test_torch_matvec_modes.py derives the bounds): with u = 2⁻⁸, bf16's unit
# roundoff, and S_ir = Σ_j |K_ij||V_jr| in float64, the kernel and its plain
# version each within MODE_BOUND[mode]·S_ir of float64, plus twice the
# 'highest' plain version's largest float64 error (the f32 accumulation)
# and K6_FLOOR of the largest value.
MODE_U = 2.0**-8
MODE_BOUND = {"default": 2 * MODE_U + MODE_U**2, "high3": 4 * MODE_U**2 + 2.0**-20}
# A bound alone admits a kernel that ignores its mode and computes the f32
# product, which sits well inside it.  Two checks hold each kernel to its
# mode's estimand.  'default' against its plain version, within
# MODE_TIGHT of the plain version's largest float64 error: the two round
# the same operands and differ only in the f32 sums, so an f32 kernel
# fails.  (For 'high3' the rounding error is about as large as the f32
# sums' own noise: its kernel is 7.6e-4 from its plain version where the
# plain version is 7.1e-4 from float64, at the trained payload.)  And both
# modes by their bias: on V = 2^e·(1 + 2⁻⁹ + 7·2⁻²⁰), positive like every
# Gram element, the bf16 parts drop a fixed share of each product,
# 2⁻⁹ + 7·2⁻²⁰ one pass and 7·2⁻²⁰ three (hi + lo keep 1 + 2⁻⁹, hi alone
# 1).  The mean over every entry of (float64 − kernel) / float64 is that
# share within MODE_BIAS_RTOL, the plain version's too.  Averaged over
# 147456 entries, the sums' noise is far below it.  An f32 kernel's bias is
# about 0 (the CPU replay: 5e-8, under 1 % of 'high3''s).
MODE_TIGHT = 0.25
MODE_BIAS = {"default": 2.0**-9 + 7 * 2.0**-20, "high3": 7 * 2.0**-20}
MODE_BIAS_RTOL = 0.1
MODE_RAGGED = (1000, 1300, 3)  # rows, columns, right-hand sides (D = 2)
PEAK_BF16 = 989e12  # the tensor cores' dense bf16 rate (H100 SXM data sheet, 700 W)
# The chunked surface against the pinned JAX runs (tools/pin_jax_chunked.py):
# float32 as serve_ref's matrix-free case (1e-3 at step 0, 1e-2 at the
# last step, the query's mean 1e-2 of its largest value), the gradients'
# relative L2 error 1e-2 (the port's prior solves run in float64, JAX's in
# float32: F6), float64 1e-10.
CHUNKED_REF = Path(__file__).resolve().parent / "tests" / "fixtures" / "jax_chunked_ref.npz"
CHUNKED_F64_RTOL, CHUNKED_GRAD_RTOL = 1e-10, 1e-2
# The chunked large-N phase: the flagship CLI (Nyström rank 1024, shift 10,
# 8-iteration chunks) at N = 16384 for CHUNKED_STEPS steps and a
# CHUNKED_QUERY-point query, then the prior-free ChunkedMAPLoss at
# CHUNKED_BIG with the row-block backward split 1 and 2 ways.
CHUNKED_N, CHUNKED_STEPS, CHUNKED_QUERY, CHUNKED_BIG = 16384, 3, 4096, 131072
CHUNKED_FLAGSHIP = ("--precond_rank", "1024", "--precond", "nystrom", "--precond_shift", "10")

# The production driver (experiments/precipitation_baselines.py) against the
# JAX driver's pinned float32 runs on tests/test_precip_baselines.py's argv
# (tools/pin_jax_baselines.py), with tests/test_torch_baselines.py's
# tolerances (their reasons in its docstring): the records' objectives
# 1e-3·max(1, |objective|), RMSE 2e-3 and NLPD 2e-2 relative; the step-0
# loss to RTOL_STEP0, the slice's bound for the same model at the same N,
# where the CPU test holds 2e-5.
BASELINES_REF = Path(__file__).resolve().parent / "tests" / "fixtures" / "jax_baselines_ref.npz"
BASELINES_OBJECTIVE_TOL = 1e-3
BASELINES_METRIC_RTOL = {"rmse": 2e-3, "rmse_raw": 2e-3, "nlpd": 2e-2}
# The dense driver run: a 1280-row CSV (x uniform on [−2, 2]², y = sin x₀ +
# 0.1·ε from default_rng(BASELINES_DENSE_SEED)), --train_percent 80.  Both
# drivers hold out int((1 − 80/100)·1280) = int(255.99999999999994) = 255
# rows, so 1025 train: inside K8's, K10a's and K11's windows.
BASELINES_DENSE_ROWS, BASELINES_DENSE_SEED = 1280, 19
BASELINES_DENSE_TRAIN = BASELINES_DENSE_ROWS - int((1 - 80 / 100) * BASELINES_DENSE_ROWS)
# The deep GP's full-covariance loss at the dgp shapes: FULL_COV_STEPS Adam
# steps, then float32 against float64 with the same ε at the trained pose.
# Bands from the CPU at the same shapes (float32 against float64 there: the
# loss 1.1e-5 relative, the gradient's relative L2 3.4e-3, cosine
# 0.999994): the loss within 1e-4, the gradient within 2e-2 and 0.9999.
FULL_COV_STEPS = 5
FULL_COV_LOSS_RTOL, FULL_COV_GRAD_REL, FULL_COV_GRAD_COS = 1e-4, 2e-2, 0.9999
# The dense CG solver at quickstart_cg_largen's N = 1600: the estimator's
# own spread over DENSE_CG_SETS independent probe sets of 16 (float64) is
# the yardstick.  The CG MLL within 3 of its σ of the Cholesky MLL; float32
# within 1 σ of float64 on the same probes, the float32 gradient within
# twice the probe sets' gradient spread (‖std‖) of the float64 one (the CPU:
# 9.8e-4 against σ 3.6e-3, 9.3e-3 against 7.5e-3).
DENSE_CG_SETS, DENSE_CG_GRAD_SPREADS = 8, 3
# The ported quickstarts, run at their defaults.
QUICKSTARTS = ("exact_gp", "gibbs_spatial", "deepgp", "cg_largen", "lazy_largen")

MMA_WALK = {"gibbs_matvec": "gibbs_mma_kernel<GibbsElem,2,2>", "rbf_matvec": "gibbs_mma_kernel<RbfElem,2,2>"}
WALK = {"K2": "gibbs_rows_kernel<GibbsElem,2,9>", "K6": "gibbs_rows_kernel<RbfElem,2,9>",
        "K3": "gibbs_rows_kernel<PanelElem,2,17>"}
# The card's peaks (H100 SXM data sheet, at the full 700 W): f32 outside the
# tensor cores, and HBM.
PEAK_F32, PEAK_BYTES = 67e12, 3.35e12


def emit(phase: str, **fields):
    print(json.dumps({"phase": phase, **fields}), flush=True)


def check(cond: bool, what: str):
    if not cond:
        raise RuntimeError(f"chip_smoke: check failed: {what}")


def sm_clock_mhz() -> float:
    """The card's maximum SM clock in MHz, as nvidia-smi reports it."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, timeout=60, check=True)
    return float(out.stdout.strip().splitlines()[0])


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def bound(ops: float, nbytes: float) -> tuple:
    """(least time in ms, what bounds it): the larger of the operations over
    the f32 peak and the bytes over the memory rate."""
    t_ops, t_bytes = ops / PEAK_F32 * 1e3, nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def _template_args(rest: str) -> list:
    """The arguments of a mangled ``I…E`` template argument list at the
    start of ``rest``: integer literals by their value, classes by the last
    component of their name (substitutions skipped)."""
    args, i = [], 1
    if not rest.startswith("I"):
        return args
    while i < len(rest) and rest[i] != "E":
        if (lit := re.match(r"L[a-z](n?\d+)E", rest[i:])):
            args.append(lit.group(1).replace("n", "-"))
            i += lit.end()
            continue
        nested = rest[i] == "N"
        i += nested
        last = None
        while i < len(rest) and rest[i] != "E":
            if (sub := re.match(r"S[0-9A-Z]*_", rest[i:])):
                i += sub.end()
            elif (num := re.match(r"\d+", rest[i:])):
                k = int(num.group())
                last = rest[i + num.end():i + num.end() + k]
                i += num.end() + k
            else:
                return args
            if not nested:
                break
        i += nested
        args.append(last)
    return args


def kernel_of(mangled: str) -> str:
    """A kernel's name and template arguments ("syrk_kernel<0,2>",
    "gibbs_rows_kernel<RbfElem,2,9>") from its mangled entry name: the first
    length-prefixed name component that ends in ``_kernel``, then its
    ``I…E`` arguments; else the name as it is."""
    rest = mangled[3:] if mangled.startswith("_ZN") else mangled[2:]
    while (d := re.match(r"\d+", rest)):
        n, rest = int(d.group()), rest[d.end():]
        name, rest = rest[:n], rest[n:]
        if name.endswith("_kernel"):
            args = _template_args(rest)
            return name + (f"<{','.join(args)}>" if args else "")
    return mangled


def ptxas_summary(log: str) -> dict:
    """{kernel<template args>: "R regs, S spill bytes"} from nvcc's -Xptxas -v."""
    out, name = {}, None
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", ln)
        if m:
            name = kernel_of(m.group(1))
        elif name and "spill stores" in ln:
            out[name] = re.search(r"(\d+) bytes spill stores", ln).group(1) + " spill bytes"
        elif name and "registers" in ln:
            regs = re.search(r"Used (\d+) registers", ln).group(1)
            out[name] = f"{regs} regs, {out.get(name, '? spill bytes')}"
            name = None
    return out


def ptxas_resources(log: str, kernel: str) -> dict:
    """{regs, spill_bytes} of one kernel from nvcc's -Xptxas -v."""
    regs, spill = re.fullmatch(r"(\d+) regs, (\d+) spill bytes", ptxas_summary(log)[kernel]).groups()
    return {"regs": int(regs), "spill_bytes": int(spill)}


def ptxas_smem(log: str, kernel: str) -> int:
    """A kernel's static shared memory in bytes from nvcc's -Xptxas -v (0
    where it reports none)."""
    name = None
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", ln)
        if m:
            name = kernel_of(m.group(1))
        elif name == kernel and "registers" in ln:
            found = re.search(r"(\d+) bytes smem", ln)
            return int(found.group(1)) if found else 0
    return 0


def timed_pair(kernel, plain, calls: int) -> dict:
    """Median per-call ms of ``kernel`` and ``plain``, timed in blocks run
    plain, kernel, kernel, plain."""
    p1, k1, k2, p2 = (block_times_ms(f, calls) for f in (plain, kernel, kernel, plain))
    return {"ms": statistics.median(k1 + k2), "plain_ms": statistics.median(p1 + p2),
            "blocks_ms": {"plain": [statistics.median(p1), statistics.median(p2)],
                          "kernel": [statistics.median(k1), statistics.median(k2)]}}


def block_times_ms(fn, calls: int) -> list:
    """Per-call device times of ``fn`` over ``calls`` back-to-back calls: one
    CUDA-event pair around each block of 10, one entry per block, warm-up
    excluded."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    per = []
    for _ in range(calls // 10):
        start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(10):
            fn()
        stop.record()
        stop.synchronize()
        per.append(start.elapsed_time(stop) / 10)
    return per


def chol_bound_ratio(l: torch.Tensor, a: torch.Tensor) -> float:
    """Largest entrywise |LLᵀ − A| / (γ_{N+1}|L||Lᵀ| + (N + 1)·2⁻¹⁴⁹) of a
    factor or a stack of them, in float64: the backward-error bound of a
    Cholesky factor (Higham, Theorem 10.3).  The theorem assumes no
    underflow; gradual underflow adds at most 2⁻¹⁴⁹ (the subnormal spacing)
    an operation, (N + 1)·2⁻¹⁴⁹ an entry.  Only entries at the subnormal
    scale feel it: the noisy Gibbs Grams at init hold 1e-45, where potrf's
    own residual (5e-46) is 2860 times γ_(N+1)|L||Lᵀ| (2e-49)."""
    n = a.shape[-1]
    gamma = (n + 1) * 2.0**-24 / (1 - (n + 1) * 2.0**-24)
    lk = l.double()
    resid = lk @ lk.mT - a.double()
    return float((resid.abs() / (gamma * (lk.abs() @ lk.abs().mT) + (n + 1) * 2.0**-149)).max())


def k1_errors(chol_inv, k, well_conditioned: bool):
    """K1 and its plain version on the same stack, both against the float64
    factor.  Every stack: finite output, the same jitter ladder, L within
    TOL_L_F64 of float64 and ‖L⁻¹L − I‖∞ ≤ TOL_LINV_RESIDUAL.  A well-
    conditioned stack (the kind tests/test_torch_chol_inv.py uses): kernel
    and plain within TOL_KERNEL_PLAIN of each other.  An ill-conditioned one
    (the slice's Gram, cond ~ 1e3) leaves L⁻¹ with f32 error that grows with
    the condition number in both versions, so there the kernel's L⁻¹ must be
    as close to float64 as the plain version's, within a factor of two."""
    l, li, jit = chol_inv.chol_inv_batched_cuda(k)
    pl, pli, pjit = chol_inv.chol_inv_batched_safe_plain(k)
    torch.cuda.synchronize()
    check(bool(torch.isfinite(l).all() and torch.isfinite(li).all()), "K1 output finite")
    check(torch.equal(jit, pjit), f"jitter ladder matches the plain version ({jit.tolist()} vs {pjit.tolist()})")
    l64 = torch.linalg.cholesky(k.double())
    eye = torch.eye(k.shape[-1], dtype=torch.float64, device=k.device)
    li64 = torch.linalg.solve_triangular(l64, eye.expand_as(l64), upper=False)

    def rel(a, ref):
        return float((a.double() - ref).abs().max() / ref.abs().max())

    err = {
        "bound_ratio": chol_bound_ratio(l, k),
        "plain_bound_ratio": chol_bound_ratio(pl, k),
        "l_vs_f64": rel(l, l64),
        "plain_l_vs_f64": rel(pl, l64),
        "linv_vs_f64": rel(li, li64),
        "plain_linv_vs_f64": rel(pli, li64),
        "linv_residual": float((li.double() @ l.double() - eye).abs().max()),
        "l_vs_plain": rel(l, pl.double()),
        "linv_vs_plain": rel(li, pli.double()),
        "max_abs_err": float(max((l - pl).abs().max(), (li - pli).abs().max())),
    }
    check(err["bound_ratio"] <= 1.0, f"K1 backward error within γ_(N+1)|L||Lᵀ|: ratio {err['bound_ratio']:.3g} <= 1")
    check(err["l_vs_f64"] <= TOL_L_F64, f"L vs float64 {err['l_vs_f64']:.3g} <= {TOL_L_F64}")
    check(err["linv_residual"] <= TOL_LINV_RESIDUAL, f"L⁻¹L − I {err['linv_residual']:.3g} <= {TOL_LINV_RESIDUAL}")
    if well_conditioned:
        check(err["l_vs_plain"] <= TOL_KERNEL_PLAIN, f"L vs plain {err['l_vs_plain']:.3g} <= {TOL_KERNEL_PLAIN}")
        check(err["linv_vs_plain"] <= TOL_KERNEL_PLAIN,
              f"L⁻¹ vs plain {err['linv_vs_plain']:.3g} <= {TOL_KERNEL_PLAIN}")
    else:
        check(err["linv_vs_f64"] <= 2 * err["plain_linv_vs_f64"] + TOL_KERNEL_PLAIN,
              f"L⁻¹ vs float64 {err['linv_vs_f64']:.3g} within 2x the plain version's "
              f"{err['plain_linv_vs_f64']:.3g} (+{TOL_KERNEL_PLAIN})")
    return err


def phase_k1(chol_inv, spatial_gibbs, dev):
    from nonstationary_precip_tpu_torch.data.datasets import load_uib_spatial
    from nonstationary_precip_tpu_torch.models.gibbs_gp import noisy_gibbs_gram
    from nonstationary_precip_tpu_torch.train.config import ExperimentConfig
    from nonstationary_precip_tpu_torch.train.vmapped import stack_modules

    cfg = ExperimentConfig(device="cuda")
    _, x, y = load_uib_spatial()
    x_norm = (x - x.mean(0)) / x.std(0, ddof=1)
    y_norm = (y - y.mean()) / y.std(ddof=1)
    splits = [spatial_gibbs.make_split(x_norm, y_norm, s, cfg, torch.float32, dev) for s in range(10)]
    with torch.no_grad():
        gram = noisy_gibbs_gram(stack_modules([s[0] for s in splits]), torch.stack([s[1][0] for s in splits]))
    check(tuple(gram.shape) == (10, 316, 316), f"slice Gram shape {tuple(gram.shape)}")

    gen = torch.Generator().manual_seed(173)
    b = torch.randn(10, 316, 316, generator=gen, dtype=torch.float64)
    spd = (b @ b.mT / 316 + 0.5 * torch.eye(316, dtype=torch.float64)).float().to(dev)
    errs = {"gibbs_gram": k1_errors(chol_inv, gram.contiguous(), well_conditioned=False),
            "random_spd": k1_errors(chol_inv, spd, well_conditioned=True)}
    # N = 384, the kernel's largest: its 78 tiles (312 KB) held whole in the
    # shared memory of one cluster, and the slice's ten clusters on the card
    # at once
    b384 = torch.randn(2, 384, 384, generator=gen, dtype=torch.float64)
    spd384 = (b384 @ b384.mT / 384 + 0.5 * torch.eye(384, dtype=torch.float64)).float().to(dev)
    cluster = chol_inv.cluster_size()
    smem = {n: chol_inv.smem_bytes(n) for n in (316, 384)}
    limit = chol_inv.max_smem(dev.index or 0)
    co_resident = {n: chol_inv.max_active_clusters(n) for n in (316, 384)}
    check(smem[384] <= limit, f"N = 384 in shared memory: {smem[384]} bytes a CTA <= {limit}")
    check(cluster * smem[384] >= 4 * 78 * 32 * 32, "a cluster holds N = 384's 78 tiles")
    check(co_resident[316] >= 10, f"ten clusters of the slice co-resident: {co_resident[316]}")
    errs["random_spd_384"] = k1_errors(chol_inv, spd384, well_conditioned=True)

    # a rank-30 member: plain f32 Cholesky fails; per-member retry
    sb = torch.randn(316, 30, generator=gen, dtype=torch.float64)
    bad = spd.clone()
    bad[3] = (sb @ sb.T).float().to(dev)
    l_a, li_a, j_a = chol_inv.chol_inv_batched_cuda(spd)
    l_b, li_b, j_b = chol_inv.chol_inv_batched_cuda(bad)
    _, _, pj_b = chol_inv.chol_inv_batched_safe_plain(bad)
    torch.cuda.synchronize()
    check(bool(torch.isfinite(l_b).all() and torch.isfinite(li_b).all()), "retried member finite")
    check(float(j_b[3]) > 0 and int((j_b != 0).sum()) == 1, f"only the bad member jittered: {j_b.tolist()}")
    check(torch.equal(j_b, pj_b), f"retry ladder matches the plain version ({j_b.tolist()} vs {pj_b.tolist()})")
    healthy = [i for i in range(10) if i != 3]
    check(torch.equal(l_a[healthy], l_b[healthy]) and torch.equal(li_a[healthy], li_b[healthy]),
          "healthy members bit-identical to the all-healthy run")
    check(torch.equal(j_a, torch.zeros_like(j_a)), "all-healthy run used no jitter")

    g = gram.contiguous()
    reps = [chol_inv.chol_inv_batched_cuda(g) for _ in range(2)]
    check(all(torch.equal(x, y) for x, y in zip(*reps)), "K1 bitwise repeatable")
    # times at the slice's shape, on the real Gram: plain, kernel, kernel, plain
    plain = lambda: chol_inv.chol_inv_batched_safe_plain(g)  # noqa: E731
    kernel = lambda: chol_inv.chol_inv_batched_cuda(g)  # noqa: E731
    t = timed_pair(kernel, plain, N_TIMED)
    emit("k1", shape=[10, 316], errors=errs, retry_jitter=j_b.tolist(), cluster=cluster, smem_bytes=smem,
         smem_limit=limit, max_active_clusters=co_resident, timed_calls=2 * N_TIMED, **t)
    return errs, t["ms"], t["plain_ms"], {"cluster": cluster, "smem_bytes": smem[316], "gram": g}


def phase_slice(chol_inv, spatial_gibbs, steps: int, dev_name: str):
    from nonstationary_precip_tpu_torch.train.config import ExperimentConfig

    ref = np.load(Path(__file__).resolve().parent / "tests" / "fixtures" / "jax_spatial_gibbs_ref.npz")
    check(steps > int(ref["steps"]), f"--steps must exceed {int(ref['steps'])} to compare with the pinned losses")
    cfg = ExperimentConfig(lr=0.01, max_iters=5000).parse_args(["--max_iters", str(steps), "--device", "cuda"])
    with tempfile.TemporaryDirectory() as out_dir:
        os.environ["NSGP_RESULTS_DIR"] = out_dir
        reset_launches()
        out = spatial_gibbs.run(cfg)
        launches = chol_inv.LAUNCHES
        field = np.loadtxt(out["csv"], delimiter=",", skiprows=1)
    losses = out["losses"]
    check(launches >= steps, f"K1 launched {launches} times over {steps} steps")
    # K9: the stacked (10, 316²) Gram of every step, as JAX's vmap gives it
    # (F-P5); two stacked Grams in the evaluation (316², 79 × 316; the
    # 79² test Grams stay plain, 6241 < 128², as in JAX); three 2-D Grams
    # in the last split's field prediction (train 316², all sites 394²,
    # 394 × 316)
    k9 = steps + 2 + 3
    check_launches({"chol_inv_batched": launches, "gibbs_gram": k9}, "slice")
    check(losses.shape == (steps, 10), f"loss trace shape {losses.shape}")
    check(bool(np.isfinite(losses).all()), "every loss finite")
    check(bool((losses[-1] < losses[0]).all()), "every split's final loss below its step-0 loss")
    rel0 = np.abs(losses[0] - ref["loss_step0"]) / np.abs(ref["loss_step0"])
    rel50 = np.abs(losses[50] - ref["loss_step50"]) / np.abs(ref["loss_step50"])
    check(float(rel0.max()) <= RTOL_STEP0, f"step-0 losses vs JAX: {rel0.max():.3g} <= {RTOL_STEP0}")
    check(float(rel50.max()) <= RTOL_STEP50, f"step-50 losses vs JAX: {rel50.max():.3g} <= {RTOL_STEP50}")
    check(field.shape == (394, 6) and bool(np.isfinite(field).all()), f"field CSV {field.shape}, finite")
    check(np.isfinite(out["rmse"]) and np.isfinite(out["nlpd"]), "metrics finite")
    emit("slice", steps=steps, launches=launches, k9_launches=k9, steps_per_s=out["steps_per_s"],
         train_seconds=out["train_seconds"], wall_seconds=out["wall_seconds"], rmse=out["rmse"],
         nlpd=out["nlpd"], step0_rel_err=float(rel0.max()), step50_rel_err=float(rel50.max()),
         final_loss=losses[-1].tolist(), device=dev_name)
    return launches, k9


def _counters():
    """{kernel name: (the module holding its plain count, the count's name)}."""
    from nonstationary_precip_tpu_torch.ops import (chol_blocked, chol_inv, chol_stream, gibbs_fused, gibbs_gram,
                                                    svgp_precompute, trsm)

    return {"chol_inv_batched": (chol_inv, "LAUNCHES"), "svgp_precompute": (svgp_precompute, "LAUNCHES"),
            "streaming_cholesky": (chol_stream, "LAUNCHES"), "gibbs_chol_solve_fused": (gibbs_fused, "LAUNCHES"),
            "gibbs_gram": (gibbs_gram, "LAUNCHES"), "blocked_cholesky": (chol_blocked, "LAUNCHES"),
            "blocked_trsm": (trsm, "LAUNCHES"), "chol_inv_grid": (chol_inv, "GRID_LAUNCHES"),
            "streaming_cholesky_v1": (chol_stream, "V1_LAUNCHES")}


def launch_counts() -> dict:
    """Every hand-written kernel's launch count, by name."""
    from nonstationary_precip_tpu_torch.ops import elbo_fused, matvec

    return {**{k: getattr(m, a) for k, (m, a) in _counters().items()}, **matvec.LAUNCHES, **elbo_fused.LAUNCHES}


def reset_launches():
    from nonstationary_precip_tpu_torch.ops import elbo_fused, matvec

    for m, a in _counters().values():
        setattr(m, a, 0)
    for counts in (matvec.LAUNCHES, elbo_fused.LAUNCHES):
        for k in counts:
            counts[k] = 0


def check_launches(want: dict, path: str) -> dict:
    """The counts since the last reset: ``want``'s kernels as given, every
    other kernel none."""
    got = launch_counts()
    expect = {k: want.get(k, 0) for k in got}
    check(got == expect, f"{path}: launches {got} == {expect}")
    return got


def largen_launches(cfg, out) -> dict:
    """K2: one launch per mBCG iteration, in each training step, in the
    trained-pose diagnostics and in the lazy loss the oracle is held to; K3:
    one per backward, in each step and in that loss; no other kernel (the
    dense oracle builds its Gram with the plain Gram, not K9)."""
    return {"gibbs_matvec": cfg.steps * out["iters"] + 2 * out["iters"], "gibbs_panel_grads": cfg.steps + 1}


def phase_largen_ref(gibbs_largen):
    """The large-N experiment at the pinned run's N on its data and probe
    draws: the losses at steps 0 and 19 against JAX's."""
    ref = np.load(LARGEN_REF)
    cfg = gibbs_largen.LargeNConfig(n=int(ref["n"]), steps=int(ref["steps"]), rank=int(ref["rank"]),
                                    iters=int(ref["iters"]), device="cuda")
    reset_launches()
    out = gibbs_largen.run(cfg, probe_noise=(ref["u1"], ref["u2"]), data=(ref["x"], ref["y"]))
    check_launches(largen_launches(cfg, out), "largen_ref")
    losses = out["losses"]
    rel = np.abs(losses - ref["losses"]) / np.abs(ref["losses"])
    check(losses.shape == ref["losses"].shape, f"loss trace shape {losses.shape}")
    check(float(rel[0]) <= LARGEN_RTOL_STEP0, f"step-0 loss vs JAX: {rel[0]:.3g} <= {LARGEN_RTOL_STEP0}")
    check(float(rel[-1]) <= LARGEN_RTOL_STEP19, f"step-19 loss vs JAX: {rel[-1]:.3g} <= {LARGEN_RTOL_STEP19}")
    emit("largen_ref", n=cfg.n, step0_rel_err=float(rel[0]), step19_rel_err=float(rel[-1]),
         losses=losses.tolist(), jax_losses=ref["losses"].tolist(), relres_solve=out["relres_solve"],
         jax_relres_solve=float(ref["relres_solve"]), loss_rel_diff=out["loss_rel_diff"],
         grad_cosine=out["grad_cosine"], jax_grad_cosine=float(ref["grad_cosine"]))


def phase_largen(gibbs_largen, dev_name: str):
    """The gate at full size, counting K2's and K3's launches over it."""
    cfg = gibbs_largen.LargeNConfig(n=LARGEN_N, device="cuda")
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    out = gibbs_largen.run(cfg)
    launches = check_launches(largen_launches(cfg, out), "largen")
    check(out["relres_solve"] <= GATE_RELRES, f"relres_solve {out['relres_solve']:.3g} <= {GATE_RELRES}")
    check(out["loss_rel_diff"] <= GATE_LOSS_REL, f"loss vs dense {out['loss_rel_diff']:.3g} <= {GATE_LOSS_REL}")
    check(out["grad_cosine"] >= GATE_COSINE, f"gradient cosine {out['grad_cosine']:.5f} >= {GATE_COSINE}")
    check(not out["diag"]["broke"], "no mBCG breakdown")
    emit("largen", n=cfg.n, steps=cfg.steps, rank=cfg.rank, iters=out["iters"], launches=launches,
         relres_solve=out["relres_solve"], diag=out["diag"], loss_lazy=out["loss_lazy"],
         loss_dense=out["loss_dense"], loss_rel_diff=out["loss_rel_diff"], grad_cosine=out["grad_cosine"],
         loss_first=float(out["losses"][0]), loss_last=float(out["losses"][-1]),
         train_seconds=out["train_seconds"], wall_seconds=out["wall_seconds"],
         peak_mem_gb=torch.cuda.max_memory_allocated() / 2**30, device=dev_name)
    return out, launches


def largen_payloads(gibbs_largen, out, dev):
    """(x, ℓ) of the gate at its init pose (ℓ = 1) and at its trained pose."""
    x, _ = gibbs_largen._data(LARGEN_N)
    x = x.to(dev)
    ell = torch.exp(torch.as_tensor(out["params"]["log_ell_pp"], device=dev)).contiguous()
    return {"init": (x, torch.ones_like(x)), "trained": (x, ell)}


def gibbs_matvec_f64(x1, l1, x2, l2, v, block: int = 2048):
    """K(x1, x2) @ v in float64 on the card, row panels of the plain Gram."""
    from nonstationary_precip_tpu_torch.kernels.gibbs import gibbs_gram_reference

    x2d, l2d, vd = x2.double(), l2.double(), v.double()
    return torch.cat([gibbs_gram_reference(x1[i:i + block].double(), l1[i:i + block].double(), x2d, l2d) @ vd
                      for i in range(0, x1.shape[0], block)])


def phase_k2(matvec, payloads, dev):
    """K2 against its plain version (K2_RTOL / K2_ATOL) and against float64
    (K6's criterion) on the gate's init and trained payloads and a ragged
    one at D = 3 (the per-dim element); bitwise repeat; times; the FP32
    bound and the special-function-unit bound."""
    gen = torch.Generator().manual_seed(29)
    v = torch.randn(LARGEN_N, 9, generator=gen).to(dev)
    errs = {}

    def compare(name, x1, l1, x2, l2, vv):
        k = matvec.gibbs_gram_matvec_cuda(x1, l1, x2, l2, vv)
        again = matvec.gibbs_gram_matvec_cuda(x1, l1, x2, l2, vv)
        p = matvec.gibbs_gram_matvec_plain(x1, l1, x2, l2, vv)
        ref = gibbs_matvec_f64(x1, l1, x2, l2, vv)
        torch.cuda.synchronize()
        err = (k - p).abs()
        ek, ep = float((k.double() - ref).abs().max()), float((p.double() - ref).abs().max())
        largest = float(ref.abs().max())
        errs[name] = {"max_abs_err": float(err.max()), "max_rel_err": float((err / p.abs().clamp_min(1e-30)).max()),
                      "max_abs_ref": float(p.abs().max()), "kernel_vs_f64": ek, "plain_vs_f64": ep,
                      "largest": largest}
        check(bool(torch.isfinite(k).all()), f"K2 {name} finite")
        check(bool((err <= K2_ATOL + K2_RTOL * p.abs()).all()), f"K2 {name} within rtol {K2_RTOL} / atol {K2_ATOL}")
        check(ek <= 2 * ep + K6_FLOOR * largest,
              f"K2 {name} vs float64 {ek:.3g} within 2x the plain version's {ep:.3g} (+{K6_FLOOR} x {largest:.3g})")
        check(torch.equal(k, again), f"K2 {name} bitwise repeatable")

    for pose, (x, ell) in payloads.items():
        compare(pose, x, ell, x, ell, v)
    n1, n2, d, r = RAGGED
    rag = [torch.randn(*shape, generator=gen) for shape in ((n1, d), (n1, d), (n2, d), (n2, d), (n2, r))]
    x1, l1, x2, l2, vr = (t.to(dev) for t in (2 * rag[0], torch.exp(0.3 * rag[1]), 2 * rag[2], torch.exp(0.3 * rag[3]),
                                               rag[4]))
    compare("ragged", x1, l1, x2, l2, vr)
    x, ell = payloads["trained"]
    t = timed_pair(lambda: matvec.gibbs_gram_matvec_cuda(x, ell, x, ell, v),
                   lambda: matvec.gibbs_gram_matvec_plain(x, ell, x, ell, v), N_TIMED_GRAM)
    ops = matvec.matvec_ops(LARGEN_N, LARGEN_N, 2, 9)
    fp32_ms, fp32_by = bound(ops, 4 * (4 * LARGEN_N * 2 + 2 * LARGEN_N * 9))
    # the SFU: 16 operations a clock an SM at the card's maximum SM clock
    clock_hz = sm_clock_mhz() * 1e6
    sfu_ms = matvec.matvec_sfu_ops(LARGEN_N, LARGEN_N, 2) / (16 * torch.cuda.get_device_properties(dev).multi_processor_count
                                                            * clock_hz) * 1e3
    b_ms, b_by = max((fp32_ms, fp32_by), (sfu_ms, "operations"))
    emit("k2", shape=[LARGEN_N, LARGEN_N, 2, 9], ragged=list(RAGGED), errors=errs, ops=ops,
         sfu_ops=matvec.matvec_sfu_ops(LARGEN_N, LARGEN_N, 2), fp32_bound_ms=fp32_ms, sfu_bound_ms=sfu_ms,
         sm_clock_mhz=clock_hz / 1e6, bound_ms=b_ms, bound_by=b_by, timed_calls=2 * N_TIMED_GRAM, **t)
    return errs, t, b_ms, b_by, lambda: matvec.gibbs_gram_matvec_cuda(x, ell, x, ell, v)


def phase_k3(matvec, payloads, dev):
    """K3 against its plain version (K3_TOL of each output's largest entry)
    and against float64 (K2's criterion: within twice the plain version's
    error plus K6_FLOOR of the largest entry) on the gate's init and trained
    payloads (16384, R 8), its row form on one block, and a ragged row form
    at D = 3 (the per-dim element); bitwise repeat; times; the FP32 bound of
    the recounted operations (and of the per-dim count it replaced) and the
    special-function-unit bound (2 an element); the bound is the larger."""
    gen = torch.Generator().manual_seed(31)
    a, s, z = (torch.randn(*shape, generator=gen).to(dev) for shape in ((LARGEN_N,), (LARGEN_N, 8), (LARGEN_N, 8)))
    errs = {}

    def compare(name, got, ref, ref64):
        torch.cuda.synchronize()
        e = {}
        for g, p, q, what in zip(got, ref, ref64, ("gx", "gl", "sp")):
            check(bool(torch.isfinite(g).all()), f"K3 {name} {what} finite")
            e[what] = float((g - p).abs().max() / p.abs().max())
            check(e[what] <= K3_TOL, f"K3 {name} {what}: {e[what]:.3g} of its largest entry <= {K3_TOL}")
            ek, ep = float((g.double() - q).abs().max()), float((p.double() - q).abs().max())
            largest = float(q.abs().max())
            e[f"{what}_vs_f64"], e[f"{what}_plain_vs_f64"] = ek / largest, ep / largest
            check(ek <= 2 * ep + K6_FLOOR * largest,
                  f"K3 {name} {what} vs float64 {ek:.3g} within 2x the plain version's {ep:.3g} "
                  f"(+{K6_FLOOR} x {largest:.3g})")
        e["max_abs_err"] = max(float((g - p).abs().max()) for g, p in zip(got, ref))
        errs[name] = e

    def f64(*args):
        return tuple(t.double() for t in args)

    for pose, (x, ell) in payloads.items():
        compare(pose, matvec.packed_gibbs_panel_grads(x, ell, a, s, z),
                matvec.packed_gibbs_panel_grads_plain(x, ell, a, s, z),
                matvec.packed_gibbs_panel_grads_plain(*f64(x, ell, a, s, z)))
    x, ell = payloads["trained"]
    sl = slice(*K3_ROWS)
    again = matvec.packed_gibbs_panel_grads(x, ell, a, s, z)
    rows = (x[sl], ell[sl], a[sl], s[sl], z[sl], x, ell, a, s, z)
    compare("rows", matvec.packed_gibbs_panel_grads_rows(*rows), matvec.packed_gibbs_panel_grads_rows_plain(*rows),
            matvec.packed_gibbs_panel_grads_rows_plain(*f64(*rows)))
    nr, n, d, r = K3_RAGGED
    xr, lr, ar, sr, zr = (t.to(dev) for t in (2 * torch.randn(n, d, generator=gen),
                                              torch.exp(0.3 * torch.randn(n, d, generator=gen)),
                                              *(torch.randn(*shape, generator=gen) for shape in ((n,), (n, r), (n, r)))))
    rag = (xr[:nr], lr[:nr], ar[:nr], sr[:nr], zr[:nr], xr, lr, ar, sr, zr)
    compare("ragged", matvec.packed_gibbs_panel_grads_rows(*rag), matvec.packed_gibbs_panel_grads_rows_plain(*rag),
            matvec.packed_gibbs_panel_grads_rows_plain(*f64(*rag)))
    full = matvec.packed_gibbs_panel_grads(x, ell, a, s, z)
    check(all(torch.equal(p, q) for p, q in zip(full, again)), "K3 bitwise repeatable")
    t = timed_pair(lambda: matvec.packed_gibbs_panel_grads(x, ell, a, s, z),
                   lambda: matvec.packed_gibbs_panel_grads_plain(x, ell, a, s, z), N_TIMED_GRAM)
    ops = matvec.panel_grads_ops(LARGEN_N, LARGEN_N, 2, 8)
    # reads x, ℓ and α, S, Z once; writes ∂x, ∂ℓ and the row sums
    nbytes = 4 * LARGEN_N * (2 * 2 + 1 + 2 * 8 + 2 * 2 + 1)
    fp32_ms, fp32_by = bound(ops, nbytes)
    per_dim_ms = bound(matvec.panel_grads_ops_per_dim(LARGEN_N, LARGEN_N, 2, 8), nbytes)[0]
    clock_hz = sm_clock_mhz() * 1e6
    sfu_ops = matvec.panel_grads_sfu_ops(LARGEN_N, LARGEN_N, 2)
    sfu_ms = sfu_ops / (16 * torch.cuda.get_device_properties(dev).multi_processor_count * clock_hz) * 1e3
    b_ms, b_by = max((fp32_ms, fp32_by), (sfu_ms, "operations"))
    emit("k3", n=LARGEN_N, r=8, rows=list(K3_ROWS), ragged=list(K3_RAGGED), errors=errs, ops=ops, sfu_ops=sfu_ops,
         fp32_bound_ms=fp32_ms, sfu_bound_ms=sfu_ms, per_dim_count_bound_ms=per_dim_ms, sm_clock_mhz=clock_hz / 1e6,
         bound_ms=b_ms, bound_by=b_by, timed_calls=2 * N_TIMED_GRAM, **t)
    f1, f2 = matvec.cotangent_factors(a, s, z)  # the wrapper alone: the factors' torch ops are not K3's
    return errs, t, b_ms, b_by, lambda: matvec._panel_grads_cuda(x, ell, f1, x, ell, f2)


def build_all(chol_inv, matvec, svgp_precompute, chol_stream, elbo_fused, gibbs_gram, chol_blocked, trsm,
              gibbs_fused) -> dict:
    """The eleven nvcc runs at once, each timed on its own; returns
    {library: nvcc's output}."""
    def timed(build):
        t0 = time.perf_counter()
        log = build(force=True)
        return time.perf_counter() - t0, log

    def lines(log):
        return [ln.strip() for ln in log.splitlines() if "registers" in ln or "spill" in ln or "Compiling entry" in ln]

    builds = [m.build for m in (chol_inv, matvec, svgp_precompute, chol_stream, elbo_fused, gibbs_gram,
                                 chol_blocked, trsm, gibbs_fused)] + [chol_stream.build_v1, matvec.build_f64]
    with ThreadPoolExecutor(len(builds)) as pool:
        jobs = [pool.submit(timed, b) for b in builds]
        (k1_s, k1_log), (gm_s, gm_log), (k4_s, k4_log), (k5_s, k5_log), (k7_s, k7_log), *dense, (k12_s, k12_log) = (
            j.result() for j in jobs)
    emit("build", kernel="chol_inv_batched", seconds=k1_s, ptxas=ptxas_summary(k1_log),
         sources=sources_of(chol_inv.SOURCE))
    emit("build", kernel="gibbs_matvec", seconds=gm_s, ptxas=ptxas_summary(gm_log), sources=sources_of(matvec.SOURCE))
    emit("build", kernel="svgp_precompute", seconds=k4_s, ptxas=ptxas_summary(k4_log),
         sources=sources_of(svgp_precompute.SOURCE))
    emit("build", kernel="chol_stream", seconds=k5_s, ptxas=lines(k5_log), sources=sources_of(chol_stream.SOURCE))
    emit("build", kernel="elbo_fused", seconds=k7_s, ptxas=ptxas_summary(k7_log), sources=sources_of(elbo_fused.SOURCE))
    for name, (sec, log), src in zip(("gibbs_gram", "chol_blocked", "trsm", "gibbs_fused", "chol_stream_v1"), dense,
                                     (gibbs_gram.SOURCE, chol_blocked.SOURCE, trsm.SOURCE, gibbs_fused.SOURCE,
                                      chol_stream.V1_SOURCE)):
        emit("build", kernel=name, seconds=sec, ptxas=ptxas_summary(log), sources=sources_of(src))
    emit("build", kernel="se_matvec_f64", seconds=k12_s, ptxas=ptxas_summary(k12_log),
         sources=sources_of(matvec.SOURCE_F64))
    return {"chol_inv": k1_log, "gibbs_matvec": gm_log, "svgp_precompute": k4_log, "elbo_fused": k7_log,
            "chol_stream": k5_log, "chol_blocked": dense[1][1], "trsm": dense[2][1], "gibbs_fused": dense[3][1],
            "chol_stream_v1": dense[4][1], "gibbs_gram": dense[0][1], "se_matvec_f64": k12_log}


def sources_of(source: Path) -> list:
    """A CUDA source and the headers of the port it includes, in the order
    met (names relative to its directory)."""
    out, todo = [], [source.name]
    while todo:
        name = todo.pop(0)
        if name in out:
            continue
        out.append(name)
        todo += re.findall(r'^#include "([\w.]+)"', (source.parent / name).read_text(), flags=re.M)
    return out


def rl_resources(attributes: dict, log: str) -> dict:
    """{kernel: {regs, spill_bytes, smem_bytes}} of the kernels that one
    library launches (its ``kernel_attributes()``: csrc/chol_rl.cuh's, or
    K11's): registers and spill stores from ptxas's report, shared memory
    (static and dynamic) from the runtime."""
    ptxas = ptxas_summary(log)
    # each chol_rl library instantiates one kernel a role: diag_kernel<K8's
    # hooks>, panel_kernel<hooks>, syrk_kernel<mode, CTAs an SM, hooks>
    prefix = {"diag_kernel": "diag_kernel<", "panel_kernel": "panel_kernel<",
              "syrk_kernel<column>": "syrk_kernel<0,", "syrk_kernel<triangle>": "syrk_kernel<1,",
              "trsm_row_kernel": "trsm_row_kernel"}
    out = {}
    for name, a in attributes.items():
        p = prefix[name]
        (summary,) = [v for k, v in ptxas.items() if k == p or (p[-1] in "<," and k.startswith(p))]
        regs, spill = re.fullmatch(r"(\d+) regs, (\d+) spill bytes", summary).groups()
        out[name] = {"regs": int(regs), "spill_bytes": int(spill), "smem_bytes": a["static_smem"] + a["dynamic_smem"]}
    return out


def phase_dgp_ref(deepgp_spatial, svgp_precompute, dev):
    """The deep GP at full width from the pinned JAX run's init, schedule and
    ε (2 splits, 10 steps): its losses at steps 0 and 9 against JAX's."""
    from nonstationary_precip_tpu_torch import interop
    from nonstationary_precip_tpu_torch.data.dataprep import load_csv
    from nonstationary_precip_tpu_torch.models.svgp import precompute_inputs
    from nonstationary_precip_tpu_torch.train.optim import _epoch_schedule, fit_minibatched_splits
    from nonstationary_precip_tpu_torch.train.vmapped import unstack_module
    from nonstationary_precip_tpu_torch.utils.config import DATASET_DIR

    ref = np.load(DGP_REF)
    splits = [int(s) for s in ref["splits"]]
    steps = ref["losses"].shape[0]
    cfg = deepgp_spatial.default_config().parse_args(["--num_epochs", str(steps), "--device", "cuda"])
    data = load_csv(DATASET_DIR / "uib_spatial.csv")
    preps = [deepgp_spatial.prep_split(data, s, cfg, torch.float32, dev) for s in splits]
    x = np.stack([p[1][0].cpu().numpy() for p in preps]).astype(np.float64)
    y = np.stack([p[1][1].cpu().numpy() for p in preps]).astype(np.float64)
    sums = np.stack([x.sum(axis=(-1, -2)), (x * x).sum(axis=(-1, -2)), y.sum(axis=-1)], axis=-1)
    check(np.allclose(sums, ref["checksums"], rtol=1e-12, atol=0), "the pinned run trains the port's splits")
    sched = np.stack([_epoch_schedule(s, x.shape[1], steps, cfg.batch_size) for s in splits], axis=1)
    check(np.array_equal(sched, ref["batch_idx"]), "the port's batch schedule is the pinned run's")

    init = interop.deepgp_from_jax({k[5:]: ref[k] for k in ref.files if k.startswith("init.")}, dev)
    with torch.no_grad():
        _, _, _, jit = svgp_precompute.svgp_precompute_fused(
            *precompute_inputs(list(init.layers) + [init.head]), return_jitter=True)
    jitter = jit.reshape(len(splits), -1).cpu().numpy()
    mismatch = [[k, i] for k, i in zip(*np.nonzero((jitter > 0) != ref["jitter_init"]))]
    eps = [tuple(torch.as_tensor(ref[f"eps_{i}"][:, k], device=dev) for i in range(cfg.num_layers))
           for k in range(len(splits))]
    reset_launches()
    res = fit_minibatched_splits(unstack_module(init, len(splits)), deepgp_spatial._loss_fn(x.shape[1]),
                                 [p[1][0] for p in preps], [p[1][1] for p in preps], eps, num_epochs=steps,
                                 batch_size=cfg.batch_size, lr=float(ref["lr"]), seeds=splits)
    # one K4 call and one K7 forward and backward per step
    check_launches({"svgp_precompute": steps, "elbo_data_term_fwd": steps, "elbo_data_term_bwd": steps}, "dgp_ref")
    losses = res.losses
    rel = np.abs(losses - ref["losses"]) / np.abs(ref["losses"])
    check(bool(np.isfinite(losses).all()), "every loss finite")
    check(float(rel[0].max()) <= DGP_RTOL_STEP0, f"step-0 losses vs JAX: {rel[0].max():.3g} <= {DGP_RTOL_STEP0}")
    check(float(rel[-1].max()) <= DGP_RTOL_STEP9,
          f"step-{steps - 1} losses vs JAX: {rel[-1].max():.3g} <= {DGP_RTOL_STEP9}")
    emit("dgp_ref", splits=splits, steps=steps, step0_rel_err=float(rel[0].max()),
         step9_rel_err=float(rel[-1].max()), max_rel_err=float(rel.max()), losses=losses.tolist(),
         jax_losses=ref["losses"].tolist(), jitter_init=jitter.tolist(),
         jax_fallback_jitter_init=ref["jitter_init"].tolist(),
         jitter_differs_from_pinned_run=[[int(k), int(i)] for k, i in mismatch])


def phase_dgp(deepgp_spatial, svgp_precompute, dev_name: str):
    """The whole deep GP experiment at its default configuration (400
    epochs), counting K4's and K7's launches over it."""
    cfg = deepgp_spatial.default_config().parse_args(["--device", "cuda"])
    reset_launches()
    out = deepgp_spatial.run(cfg)
    # K4: one call per training step (each loss builds every layer's
    # factors in one call) and one for the stacked predict; K7: one forward
    # and one backward per training step; no other kernel
    launches = check_launches({"svgp_precompute": out["steps"] + 1, "elbo_data_term_fwd": out["steps"],
                               "elbo_data_term_bwd": out["steps"]}, "dgp")
    losses = out["losses"]
    check(losses.shape == (out["steps"], cfg.num_splits), f"loss trace shape {losses.shape}")
    check(bool(np.isfinite(losses).all()), "every loss finite")
    check(bool((losses[-1] < losses[0]).all()), "every split's final loss below its step-0 loss")
    check(out["rmse"] <= DGP_RMSE, f"10-split RMSE {out['rmse']:.4f} <= {DGP_RMSE}")
    check(out["nlpd"] <= DGP_NLPD, f"10-split NLPD {out['nlpd']:.4f} <= {DGP_NLPD}")
    emit("dgp", splits=cfg.num_splits, steps=out["steps"], launches=launches, rmse=out["rmse"],
         nlpd=out["nlpd"], rmses=out["rmses"].tolist(), nlpds=out["nlpds"].tolist(),
         steps_per_s=out["steps_per_s"], train_seconds=out["train_seconds"], wall_seconds=out["wall_seconds"],
         final_loss=losses[-1].tolist(), device=dev_name)
    return out, launches


def k4_errors(svgp_precompute, args):
    """K4 and its plain version on the same inputs, each against float64 at
    the jitter it took: finite outputs, zero upper triangles, and the
    kernel's error within twice the plain version's (+ K4_SLACK); then the
    kernel's L⁻¹ residual and W against their γ_M bounds.  Returns the
    errors and both jitter vectors."""
    k = svgp_precompute.svgp_precompute_cuda(*args)
    p = svgp_precompute.svgp_precompute_plain(*args)
    torch.cuda.synchronize()
    check(all(bool(torch.isfinite(a).all()) for a in k[:3]), "K4 output finite")
    check(bool((torch.triu(k[0], 1) == 0).all() and (torch.triu(k[2], 1) == 0).all()),
          "K4's L and L⁻¹ are lower triangular")

    def f64(jit):
        z, ell, s2, packed = (a.double() for a in args)
        kk = svgp_precompute.gram_zz_plain(z, ell, s2)
        kk = kk + jit.double()[:, None, None] * torch.eye(kk.shape[-1], dtype=torch.float64, device=kk.device)
        l = torch.linalg.cholesky(kk)
        eye = torch.eye(kk.shape[-1], dtype=torch.float64, device=kk.device).expand_as(kk)
        li = torch.linalg.solve_triangular(l, eye, upper=False)
        return kk, (l, li.mT @ packed, li)

    k_jit, ref_k = f64(k[3])
    ref_p = f64(p[3])[1]
    err = {"max_abs_err": float(max((a - b).abs().max() for a, b in zip(k[:3], p[:3])))}
    for i, name in enumerate(("L", "W", "Linv")):
        ek = float((k[i].double() - ref_k[i]).abs().max())
        ep = float((p[i].double() - ref_p[i]).abs().max())
        err[name] = {"kernel_vs_f64": ek, "plain_vs_f64": ep, "largest": float(ref_k[i].abs().max())}
        check(ek <= 2 * ep + K4_SLACK[name],
              f"K4 {name} vs float64 {ek:.3g} within 2x the plain version's {ep:.3g} (+{K4_SLACK[name]})")

    # bounds on K4's own arithmetic, independent of K_zz's conditioning
    l, w, li = (a.double() for a in k[:3])
    packed = args[3].double()
    m = l.shape[-1]
    gamma = m * 2.0**-24 / (1 - m * 2.0**-24)
    eye = torch.eye(m, dtype=torch.float64, device=l.device)
    w_ref = li.mT @ packed
    for name, diff, scale in (("Linv", l @ li - eye, l.abs() @ li.abs()),
                              ("W", w - w_ref, li.abs().mT @ packed.abs())):
        ratio = float((diff.abs() / (gamma * scale + 1e-300)).max())
        err[name]["bound_ratio"] = ratio
        check(ratio <= 1.0, f"K4 {name}: error within γ_M of its entrywise bound, ratio {ratio:.3g} <= 1")
    err["W"]["vs_own_Linv_rel_to_largest"] = float((w - w_ref).abs().max() / w_ref.abs().max())
    # L's backward error against K + jI at the kernel's jitter (K in float64
    # from the same f32 inputs; the kernel's f32 K differs from it by the
    # rounding of its entries, far inside the bound)
    err["L"]["bound_ratio"] = chol_bound_ratio(k[0], k_jit)
    check(err["L"]["bound_ratio"] <= 1.0,
          f"K4 L's backward error within γ_(M+1)|L||Lᵀ|: ratio {err['L']['bound_ratio']:.3g} <= 1")
    return err, k[3].cpu().numpy(), p[3].cpu().numpy()


def k4_payload(model):
    """K4's inputs on the experiment's path: every layer of every split."""
    from nonstationary_precip_tpu_torch.models.svgp import precompute_inputs

    with torch.no_grad():
        return tuple(a.detach().contiguous() for a in precompute_inputs(list(model.layers) + [model.head]))


def phase_k4(deepgp_spatial, svgp_precompute, trained_model, dev):
    from nonstationary_precip_tpu_torch.data.dataprep import load_csv
    from nonstationary_precip_tpu_torch.train.vmapped import stack_modules
    from nonstationary_precip_tpu_torch.utils.config import DATASET_DIR

    cfg = deepgp_spatial.default_config().parse_args(["--num_epochs", "1", "--device", "cuda"])
    data = load_csv(DATASET_DIR / "uib_spatial.csv")
    init_model = stack_modules([deepgp_spatial.prep_split(data, s, cfg, torch.float32, dev)[0]
                                for s in range(cfg.num_splits)])
    payloads = {"init": k4_payload(init_model), "trained": k4_payload(trained_model)}
    t, m, d = payloads["init"][0].shape
    p = payloads["init"][3].shape[-1]
    check((t, m, d, p) == (50, 250, 2, 501), f"the path's K4 shape {(t, m, d, p)}")
    gen = torch.Generator().manual_seed(37)
    rt, rm, rd = K4_RAGGED
    payloads["ragged"] = tuple(a.to(dev) for a in (
        torch.randn(rt, rm, rd, generator=gen), torch.exp(0.3 * torch.randn(rt, rd, generator=gen)) + 0.3,
        torch.exp(0.2 * torch.randn(rt, generator=gen)), torch.randn(rt, rm, 2 * rm + 1, generator=gen)))
    errs, jitter = {}, {}
    for name, args in payloads.items():
        errs[name], jk, jp = k4_errors(svgp_precompute, args)
        jitter[name] = {"kernel": jk.tolist(), "plain": jp.tolist(),
                        "differ": np.nonzero(jk != jp)[0].tolist()}

    # the retry case: member 1 has a duplicated z at s² = 40, member 0 is healthy
    z = torch.randn(2, 128, 2, generator=gen)
    z[1, 64] = z[1, 32]
    retry = tuple(a.to(dev) for a in (z, torch.ones(2, 2), torch.tensor([1.0, 40.0]),
                                      torch.randn(2, 128, 257, generator=gen)))
    l, w, li, jit = svgp_precompute.svgp_precompute_cuda(*retry)
    _, _, _, pjit = svgp_precompute.svgp_precompute_plain(*retry)
    torch.cuda.synchronize()
    check(all(bool(torch.isfinite(a).all()) for a in (l, w, li)), "retried K4 output finite")
    check(float(jit[0]) == 0.0 and float(jit[1]) > 0.0, f"only the bad member jittered: {jit.tolist()}")
    kk = svgp_precompute.gram_zz_plain(*(a.double() for a in retry[:3]))[1]
    kk = kk + float(jit[1]) * torch.eye(128, dtype=torch.float64, device=dev)
    recon = float((l[1].double() @ l[1].double().T - kk).abs().max())
    check(recon <= K4_RETRY_RECON, f"retried member's L Lᵀ − (K + jI): {recon:.3g} <= {K4_RETRY_RECON}")

    z, ell, s2, packed = payloads["trained"]
    timed = timed_pair(lambda: svgp_precompute.svgp_precompute_cuda(z, ell, s2, packed),
                       lambda: svgp_precompute.svgp_precompute_plain(z, ell, s2, packed), N_TIMED)
    # M³/3 each for the factor and the inverse and M²·P for the triangular W
    # per member (the gram's O(M²D) left out); reads z, ℓ, s², P once,
    # writes L, L⁻¹ and W
    ops = t * (2 * m**3 / 3 + m * m * p)
    b_ms, b_by = bound(ops, 4 * t * (m * d + d + 1 + m * p + 2 * m * m + m * p))
    design = {"cluster": svgp_precompute.cluster_size(), "smem_bytes": svgp_precompute.smem_bytes(m, d),
              "smem_limit": svgp_precompute.max_smem(dev.index or 0),
              "max_active_clusters": svgp_precompute.max_active_clusters(m, d)}
    check(design["max_active_clusters"] >= 1, f"a K4 cluster fits on the card: {design['max_active_clusters']}")
    emit("k4", shape=[t, m, d, p], ragged=list(K4_RAGGED), errors=errs, jitter=jitter,
         retry={"jitter": jit.tolist(), "plain_jitter": pjit.tolist(), "recon_err": recon},
         ops=ops, bound_ms=b_ms, bound_by=b_by, design=design, before=K4_BEFORE, timed_calls=2 * N_TIMED, **timed)
    return errs, timed, b_ms, b_by, design, lambda: svgp_precompute.svgp_precompute_cuda(z, ell, s2, packed)


def k7_random(gen, t, b, s, m, clip, dev):
    """K7's inputs at random (float32 on ``dev``): z ~ N(0, 1), ℓ, s² near 1,
    W ~ 0.2·N(0, 1) with its A-block (columns M+1..2M) scaled by 0.1, or by
    6 in layer 1's first group and the head when ``clip`` (their variances
    then hit the 1e-10 floor at some rows)."""
    w = 0.2 * torch.randn(t, 5, m, 2 * m + 1, generator=gen)
    w[..., m + 1:] *= 0.1
    if clip:
        w[:, [0, 4], :, m + 1:] *= 60.0
    params = {"z": torch.randn(t, 5, m, 2, generator=gen),
              "ell": torch.exp(0.2 * torch.randn(t, 5, 2, generator=gen)) + 0.3,
              "s2": torch.exp(0.2 * torch.randn(t, 5, generator=gen)), "w": w}
    for k, shape in (("mw1", (2, 2)), ("mb1", (2,)), ("mw2", (2, 2)), ("mb2", (2,)), ("mbh", (1,))):
        params[k] = 0.2 * torch.randn(t, *shape, generator=gen)
    x = torch.randn(t, b, 2, generator=gen)
    y = torch.sin(x[..., 0]) + 0.1 * torch.randn(t, b, generator=gen)
    e1, e2 = (torch.randn(t, s, 2, b, generator=gen) for _ in range(2))
    noise = 0.2 * torch.exp(0.3 * torch.randn(t, generator=gen))
    return (x.to(dev), y.to(dev), e1.to(dev), e2.to(dev), {k: v.to(dev) for k, v in params.items()}, noise.to(dev))


def k7_payload(model, xs, ys, eps):
    """K7's inputs on the deep GP's path: the stacked model's packed
    parameters (W from K4) at one step's batch and ε."""
    with torch.no_grad():
        params = {k: v.detach().contiguous() for k, v in model.elbo_params().items()}
        noise = model.likelihood.noise.detach().reshape(-1).contiguous()
    return xs, ys, eps[0].contiguous(), eps[1].contiguous(), params, noise


def k7_errors(elbo_fused, args, gbar):
    """K7's forward and backward and the plain version in float32, each
    against the plain version in float64 on the same inputs, relative to
    the largest float64 entry (at least K7_FLOOR): the kernel's error within
    twice the plain f32 version's plus K7_SLACK, for the value and every
    cotangent.
    Returns the errors and the kernel's largest absolute differences from
    the plain f32 version (forward, backward)."""
    k_dt, k_h1, k_h2 = elbo_fused.elbo_fwd_cuda(*args)
    k_bars, k_nb, k_yb = elbo_fused.elbo_bwd_cuda(*args, k_h1, k_h2, gbar)

    def plain(dtype):
        x, y, e1, e2, params, noise = args
        a = [v.to(dtype) for v in (x, y, e1, e2)]
        p = {k: v.to(dtype) for k, v in params.items()}
        dt, res = elbo_fused.reference_fwd(*a, p, noise.to(dtype))
        bars, nb, yb = elbo_fused.reference_bwd(*a, p, noise.to(dtype), res, gbar.to(dtype))
        return {"value": dt, **bars, "noise": nb, "y": yb, "h1": res[1], "h2": res[2]}

    p32, p64 = plain(torch.float32), plain(torch.float64)
    got = {"value": k_dt, **k_bars, "noise": k_nb, "y": k_yb, "h1": k_h1.reshape(p64["h1"].shape),
           "h2": k_h2.reshape(p64["h2"].shape)}
    torch.cuda.synchronize()
    errs, fwd_diff, bwd_diff = {}, 0.0, 0.0
    for name, ref in p64.items():
        largest = float(ref.abs().max())
        scale = max(largest, K7_FLOOR)
        ek = float((got[name].double() - ref).abs().max()) / scale
        ep = float((p32[name].double() - ref).abs().max()) / scale
        diff = float((got[name] - p32[name]).abs().max())
        check(bool(torch.isfinite(got[name]).all()), f"K7 {name} finite")
        errs[name] = {"kernel_vs_f64": ek, "plain_vs_f64": ep, "largest": largest, "kernel_vs_plain": diff}
        if name in ("value", "h1", "h2"):
            fwd_diff = max(fwd_diff, diff)
        else:
            bwd_diff = max(bwd_diff, diff)
        if name not in ("h1", "h2"):  # the sampled layer outputs are reported, not held
            slack = K7_SLACK["value" if name == "value" else "cotangent"]
            check(ek <= 2 * ep + slack,
                  f"K7 {name} vs float64 {ek:.3g} within 2x the plain version's {ep:.3g} (+{slack})")
    return errs, fwd_diff, bwd_diff


def k7_bwd_bytes(t: int, b: int, s: int, m: int) -> dict:
    """{backward kernel: MB it must move at least} at these shapes, from the
    scratch layout of csrc/elbo_fused.cu (K_xz rows of round4(M), out rows of
    round4(2M + 1), f32): each scratch row read or written once a launch, W
    (or W's groups) read once, W̄ written once; the small inputs left out."""
    r4 = lambda v: -(-v // 4) * 4  # noqa: E731
    p, kl, ol = 2 * m + 1, r4(m), r4(2 * m + 1)
    rows = {"l1": 2 * b, "l2": 2 * s * b, "head": s * b}
    k = {g: 4.0 * t * r * kl for g, r in rows.items()}
    o = {g: 4.0 * t * r * ol for g, r in rows.items()}
    w = {"l1": 4.0 * t * 2 * m * p, "l2": 4.0 * t * 2 * m * p, "head": 4.0 * t * m * p}
    out = {"elbo_k_kernel": sum(k.values()),
           "elbo_out_kernel": sum(k.values()) + sum(w.values()) + sum(o.values()),
           "elbo_bwd_head_kernel": 2 * o["head"], "elbo_bwd_layer2_kernel": 2 * o["l2"],
           "elbo_bwd_layer1_kernel": 2 * o["l1"],
           "elbo_bwd_pull_kernel": sum(o.values()) + sum(k.values()) + sum(w.values()),
           "elbo_wbar_kernel": sum(k.values()) + sum(o.values()) + sum(w.values())}
    return {name: v / 1e6 for name, v in out.items()}


def kernel_split_ms(fn, calls: int) -> dict:
    """{device kernel: ms a call} over ``calls`` traced calls of ``fn``
    (torch.profiler), after one untraced call."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        if e.device_time_total > 0:
            name = re.search(r"(\w+_kernel)", e.key).group(1)
            out[name] = out.get(name, 0.0) + e.device_time_total / 1e3 / calls
    return out


def phase_k7(deepgp_spatial, elbo_fused, trained_model, dev):
    """K7 against its plain version in float64 on the deep GP's init and
    trained payloads (10 splits, B 315, S 3, M 250), a ragged one and one
    whose variances hit the floor; a bitwise repeat; the times of the
    kernels, the plain version and the composed data term through
    autograd."""
    from nonstationary_precip_tpu_torch.data.dataprep import load_csv
    from nonstationary_precip_tpu_torch.train.vmapped import stack_modules
    from nonstationary_precip_tpu_torch.utils.config import DATASET_DIR

    cfg = deepgp_spatial.default_config().parse_args(["--num_epochs", "1", "--device", "cuda"])
    data = load_csv(DATASET_DIR / "uib_spatial.csv")
    preps = [deepgp_spatial.prep_split(data, s, cfg, torch.float32, dev) for s in range(cfg.num_splits)]
    xs = torch.stack([p[1][0] for p in preps])
    ys = torch.stack([p[1][1] for p in preps])
    eps = [torch.stack([p[3][i][0] for p in preps]) for i in range(cfg.num_layers)]  # step 0's ε, (T, S, O, B)
    payloads = {"init": k7_payload(stack_modules([p[0] for p in preps]), xs, ys, eps),
                "trained": k7_payload(trained_model, xs, ys, eps)}
    t, b, m = xs.shape[0], xs.shape[1], payloads["init"][4]["z"].shape[2]
    s = eps[0].shape[1]
    check((t, b, s, m) == (10, 315, 3, 250), f"the path's K7 shape {(t, b, s, m)}")
    gen = torch.Generator().manual_seed(41)
    payloads["ragged"] = k7_random(gen, *K7_RAGGED, False, dev)
    payloads["clip"] = k7_random(gen, *K7_CLIP, True, dev)
    with torch.no_grad():
        x, _, _, _, params, _ = payloads["clip"]
        _, var, _, _ = elbo_fused._marginals(x.double(), *elbo_fused._groups(
            {k: v.double() for k, v in params.items()}, slice(0, 2)))
    clipped = float((var <= elbo_fused.VAR_FLOOR).double().mean())
    check(0.0 < clipped < 1.0, f"the clip payload puts some of layer 1's variances on the floor: {clipped:.3g}")
    errs, fwd_diff, bwd_diff, moments = {}, 0.0, 0.0, {}
    for name, args in payloads.items():
        gbar = torch.linspace(0.5, 1.5, args[0].shape[0], device=dev)
        errs[name], fd, bd = k7_errors(elbo_fused, args, gbar)
        fwd_diff, bwd_diff = max(fwd_diff, fd), max(bwd_diff, bd)
        # the forward's per-row means and variances are the backward's, to the bit
        _, h1, h2, fwd_mom = elbo_fused.forward_moments(*args)
        bwd_mom = elbo_fused.backward_moments(*args, h1, h2)
        torch.cuda.synchronize()
        check(bool(torch.isfinite(fwd_mom).all()), f"K7 {name} forward moments finite")
        check(torch.equal(fwd_mom, bwd_mom), f"K7 {name}: the forward's per-row mean and variance are the "
                                             f"backward's to the bit (largest gap {float((fwd_mom - bwd_mom).abs().max()):.3g})")
        moments[name] = {"rows": int(fwd_mom.shape[0] * fwd_mom.shape[1]), "bitwise_equal": True}

    args = payloads["trained"]
    gbar = torch.ones(t, device=dev)
    runs = []
    for _ in range(2):
        dt, h1, h2 = elbo_fused.elbo_fwd_cuda(*args)
        bars, nb, yb = elbo_fused.elbo_bwd_cuda(*args, h1, h2, gbar)
        runs.append([dt, h1, h2, nb, yb, *bars.values()])
    check(all(torch.equal(a, c) for a, c in zip(*runs)), "K7 bitwise repeatable")

    x, y, e1, e2, params, noise = args
    fwd = timed_pair(lambda: elbo_fused.elbo_fwd_cuda(*args), lambda: elbo_fused.reference_fwd(*args), N_TIMED)
    res = elbo_fused.reference_fwd(*args)[1]
    bwd = timed_pair(lambda: elbo_fused.elbo_bwd_cuda(*args, h1, h2, gbar),
                     lambda: elbo_fused.reference_bwd(*args, res, gbar), N_TIMED)
    leaves = {k: v.clone().requires_grad_(True) for k, v in params.items()}
    leaf_noise = noise.clone().requires_grad_(True)

    def value_and_grad(fn):
        def run():
            dt = fn(x, y, e1, e2, leaves, leaf_noise)
            torch.autograd.grad(dt.sum(), [*leaves.values(), leaf_noise])
        return run

    # the fused term (both kernels) against the composed data term: the
    # plain forward in torch ops with autograd's backward
    step = timed_pair(value_and_grad(elbo_fused.fused_data_term),
                      value_and_grad(lambda *a: elbo_fused.reference_fwd(*a)[0]), N_TIMED)
    p = 2 * m + 1
    ops = 2.0 * t * (2 + 3 * s) * b * m * p  # the eleven K_xz·W products per x row
    io = 4.0 * (t * b * 3 + 2 * t * s * 2 * b + t * 5 * m * 3 + t * 14)  # x, y, ε, z, ℓ, s², mean weights, σ²
    fwd_bound = bound(ops, io + 4.0 * (t * 5 * m * p + t + 2 * t * s * b * 2))  # + W; value, h₁, h₂
    # out again, outbar·Wᵀ and K_xzᵀ·outbar: three times the forward's
    # products; reads W, h₁, h₂; writes W̄ and the small cotangents
    bwd_bound = bound(3 * ops, io + 4.0 * (2 * t * 5 * m * p + 2 * t * s * b * 2 + t * 5 * m * 3 + t * b))
    emit("k7", shape=[t, b, s, m], ragged=list(K7_RAGGED), clip=list(K7_CLIP), clipped_share=clipped, errors=errs,
         moments_fwd_vs_bwd=moments,
         ops_fwd=ops, ops_bwd=3 * ops, fwd={**fwd, "bound_ms": fwd_bound[0], "bound_by": fwd_bound[1]},
         bwd={**bwd, "bound_ms": bwd_bound[0], "bound_by": bwd_bound[1], "least_mb_moved": k7_bwd_bytes(t, b, s, m)},
         fused_vs_composed={"fused_ms": step["ms"], "composed_ms": step["plain_ms"], "blocks_ms": step["blocks_ms"]},
         timed_calls=2 * N_TIMED)
    return {"fwd": {**fwd, "bound": fwd_bound, "max_abs_err": fwd_diff},
            "bwd": {**bwd, "bound": bwd_bound, "max_abs_err": bwd_diff},
            "fwd_call": lambda: elbo_fused.elbo_fwd_cuda(*args),
            "bwd_call": lambda: elbo_fused.elbo_bwd_cuda(*args, h1, h2, gbar)}


def phase_traced(chol_inv, k1_gram, k2_call, k3_call, k4_call, k6_call, k7_fwd_call, k7_bwd_call, k9_call,
                 k10b_call, k9_stacked_call) -> dict:
    """K1's, K2's, K3's, K4's, K6's, K9's (2-D and stacked) and K10b's CUDA
    launches in one call (every device kernel counted), K7's forward and backward time by kernel,
    with the forward's CUDA launches a call, and K9's device time (the
    median duration of K9_TRACED launches), from torch.profiler.  These sessions run after k11: in
    a process that had traced other kernels first, k11's count of K11's
    programmatic dependent launches read 8 and 9 of 10 on an H100,
    where it reads 10 when k11 traces first."""
    launches = cuda_launches(lambda: chol_inv.chol_inv_batched_cuda(k1_gram), "")
    check(launches == 1, f"K1 is one CUDA launch a call: {launches}")
    k2_launches = cuda_launches(k2_call, "")
    check(k2_launches == 2, f"K2 is 2 CUDA launches a call: {k2_launches}")
    k3_launches = cuda_launches(k3_call, "")
    check(k3_launches == 2, f"K3 is 2 CUDA launches a call: {k3_launches}")
    k4_launches = cuda_launches(k4_call, "")
    check(k4_launches == 1, f"K4 is 1 CUDA launch a call: {k4_launches}")
    k6_launches = cuda_launches(k6_call, "")
    check(k6_launches == 2, f"K6 is 2 CUDA launches a call: {k6_launches}")
    fwd_launches = cuda_launches(k7_fwd_call, "")
    check(fwd_launches == 10, f"K7's forward is 10 CUDA launches a call: {fwd_launches}")
    fwd_split = kernel_split_ms(k7_fwd_call, 10)
    check(sorted(fwd_split) == sorted(K7_FWD_KERNELS), f"K7's forward launches {sorted(fwd_split)}")
    split = kernel_split_ms(k7_bwd_call, 10)
    check(sorted(split) == sorted(K7_BWD_KERNELS), f"K7's backward launches {sorted(split)}")
    k9_launches = cuda_launches(k9_call, "")
    check(k9_launches == 1, f"K9 is 1 CUDA launch a call: {k9_launches}")
    k9_stacked_launches = cuda_launches(k9_stacked_call, "")
    check(k9_stacked_launches == 1, f"K9's stacked entry is 1 CUDA launch a call: {k9_stacked_launches}")
    k10b_launches = cuda_launches(k10b_call, "")
    check(k10b_launches == 1, f"K10b is 1 CUDA launch a call: {k10b_launches}")
    for _ in range(3):  # a session can come back short of records (cuda_launches)
        k9_times = [(end - start) / 1e3 for name, start, end in device_kernels(k9_call, K9_TRACED)
                    if "gibbs_gram_kernel" in name]
        if len(k9_times) == K9_TRACED:
            break
    check(len(k9_times) == K9_TRACED, f"K9's traced launches {len(k9_times)} of {K9_TRACED}")
    k9_device_ms = statistics.median(k9_times)
    emit("traced", k1_cuda_launches_a_call=launches, k2_cuda_launches_a_call=k2_launches,
         k3_cuda_launches_a_call=k3_launches, k4_cuda_launches_a_call=k4_launches, k6_cuda_launches_a_call=k6_launches,
         k7_fwd_cuda_launches_a_call=fwd_launches, k7_fwd_split_ms=fwd_split, k7_bwd_split_ms=split,
         k9_cuda_launches_a_call=k9_launches, k9_stacked_cuda_launches_a_call=k9_stacked_launches,
         k10b_cuda_launches_a_call=k10b_launches,
         k9_device_ms={"median": k9_device_ms, "min": min(k9_times), "max": max(k9_times), "launches": len(k9_times)})
    return {"k1_launches": launches, "k9_device_ms": k9_device_ms}


def phase_field_regression(field_regression, dev_name: str):
    """The whole field-regression experiment at its default configuration
    (400 epochs, both halves): the spatial field inside the
    dgp_field_regression band, K7 launched once forward and once backward
    per spatial step and never by the D = 3 half."""
    cfg = field_regression.default_config().parse_args(["--device", "cuda"])
    reset_launches()
    out = field_regression.run(cfg)
    sp, st = out["spatial_steps"], out["st_steps"]
    # K4: one call per step and one per predict of either half; K7: the
    # spatial half's steps only (D = 3 is outside its gate)
    launches = check_launches({"svgp_precompute": sp + st + 2, "elbo_data_term_fwd": sp,
                               "elbo_data_term_bwd": sp}, "field_regression")
    for key in ("rmse_vs_ref", "corr_vs_ref", "corr_truth", "st_corr"):
        check(bool(np.isfinite(out[key])), f"{key} finite")
    check(out["rmse_vs_ref"] <= FIELD_RMSE, f"field RMSE vs the reference {out['rmse_vs_ref']:.4f} <= {FIELD_RMSE}")
    check(1 - out["corr_vs_ref"] <= FIELD_1MCORR,
          f"1 − field corr vs the reference {1 - out['corr_vs_ref']:.4f} <= {FIELD_1MCORR}")
    emit("field_regression", steps={"spatial": sp, "st": st}, launches=launches, rmse_vs_ref=out["rmse_vs_ref"],
         one_minus_corr_vs_ref=1 - out["corr_vs_ref"], corr_truth=out["corr_truth"],
         corr_truth_ref=out["corr_truth_ref"], st_corr=out["st_corr"], st_sites=out["st_sites"],
         spatial_train_seconds=out["spatial_train_seconds"], st_train_seconds=out["st_train_seconds"],
         wall_seconds=out["wall_seconds"], device=dev_name)


def chol_errors(what: str, kernel, a: torch.Tensor, others: dict) -> dict:
    """A Cholesky kernel's factor of the f32 matrix ``a`` against float64
    (K5's criterion: within twice potrf's error plus K5_FLOOR of the largest
    entry, and the kernel's backward error within γ_{N+1}|L||Lᵀ|), beside
    ``others``' factors of the same matrix (name: function), each reported."""
    l = kernel(a)
    facts = {name: fn(a) for name, fn in others.items()}
    lib = torch.linalg.cholesky(a)
    a64 = torch.tril(a.double()) + torch.tril(a.double(), -1).T  # the lower triangle each version reads
    l64 = torch.linalg.cholesky(a64)
    torch.cuda.synchronize()
    check(bool(torch.isfinite(l).all()), f"{what} factor finite")
    check(bool((torch.triu(l, 1) == 0).all()), f"{what} factor lower triangular")
    err = {name: float((t.double() - l64).abs().max())
           for name, t in (("kernel", l), ("library", lib), *facts.items())}
    largest = float(l64.abs().max())
    check(err["kernel"] <= 2 * err["library"] + K5_FLOOR * largest,
          f"{what} vs float64 {err['kernel']:.3g} within 2x potrf's {err['library']:.3g} (+{K5_FLOOR} x {largest:.3g})")
    lk = l.double()
    resid = lk @ lk.T - a64
    ratio = chol_bound_ratio(l, a64)
    check(ratio <= 1.0, f"{what} backward error within γ_(N+1)|L||Lᵀ|: ratio {ratio:.3g} <= 1")
    err.update(largest=largest, bound_ratio=ratio,
               rel_residual=float(torch.linalg.matrix_norm(resid) / torch.linalg.matrix_norm(a64)))
    if "plain" in facts:
        err["max_abs_err"] = float((l - facts["plain"]).abs().max())
    return err


def k5_errors(chol_stream, a):
    """K5, its plain version and torch.linalg.cholesky on the same f32
    matrix, each against the float64 factor (``chol_errors``)."""
    return chol_errors("K5", chol_stream.streaming_cholesky_cuda, a, {"plain": chol_stream.streaming_cholesky_plain})


def dense_gram(exact_largen, n: int, dev):
    """K5's payload on the dense path: s²·RBF(x) + σ²I of the dense run's
    data at its init pose, the matrix its first step factors."""
    x, _ = exact_largen.dense_data((n,))[n]
    model = exact_largen.dense_model(dev=dev)
    with torch.no_grad():
        k = model.kernel(x.to(dev))
        return k + model.likelihood.noise * torch.eye(n, device=dev)


def phase_k5(chol_stream, exact_largen, dev):
    from nonstationary_precip_tpu_torch.ops.linalg import safe_cholesky

    gen = torch.Generator().manual_seed(41)
    b = torch.randn(K5_RAGGED, K5_RAGGED, generator=gen, dtype=torch.float64)
    payloads = {"dense_gram": dense_gram(exact_largen, K5_N, dev),
                "ragged_spd": (b @ b.T / K5_RAGGED + torch.eye(K5_RAGGED, dtype=torch.float64)).float().to(dev)}
    del b
    errs = {name: k5_errors(chol_stream, a) for name, a in payloads.items()}
    for name, a in payloads.items():  # fixed-order sums, no atomics
        check(torch.equal(chol_stream.streaming_cholesky_cuda(a), chol_stream.streaming_cholesky_cuda(a)),
              f"K5 {name} bitwise repeatable")

    # a rank-30 PSD matrix: K5's factor is not finite, and safe_cholesky's
    # retry refactors it with jitter, each try a K5 call
    lr = torch.randn(K5_RAGGED, 30, generator=gen, dtype=torch.float64)
    bad = (lr @ lr.T).float().to(dev)
    check(not bool(torch.isfinite(chol_stream.streaming_cholesky_cuda(bad)).all()), "K5 on a non-SPD input: non-finite")
    before = chol_stream.LAUNCHES
    fixed = safe_cholesky(bad)
    tries = chol_stream.LAUNCHES - before
    check(bool(torch.isfinite(fixed).all()) and tries >= 2, f"safe_cholesky retried through K5 ({tries} calls), finite")

    a = payloads["dense_gram"]
    t = timed_pair(lambda: chol_stream.streaming_cholesky_cuda(a), lambda: chol_stream.streaming_cholesky_plain(a),
                   K5_TIMED)
    lib = block_times_ms(lambda: torch.linalg.cholesky(a), K5_TIMED) + block_times_ms(
        lambda: torch.linalg.cholesky(a), K5_TIMED)
    # N³/3 operations; reads A once, writes L
    b_ms, b_by = bound(chol_stream.cholesky_ops(K5_N), 4 * 2 * K5_N * K5_N)
    out = {"max_abs_err": max(e["max_abs_err"] for e in errs.values()), "library_ms": statistics.median(lib),
           "bound_ms": b_ms, "bound_by": b_by, **t}
    emit("k5", n=K5_N, ragged=K5_RAGGED, errors=errs, retry_calls=tries, timed_calls=2 * K5_TIMED, **out)
    return out


def phase_exact_dense(exact_largen, chol_stream, dev_name: str):
    """bench_scaling.py's exact loop at N = 1024..8192: K5 is called once
    per step at N = 8192 and K10a once per step at N = 1024, and nothing
    else; then the N = 8192 loop with the plain version in K5's place."""
    reset_launches()
    out = exact_largen.dense(dev="cuda")
    steps = len(out[K5_N]["losses"])
    # K5 once per step at N = 8192, K10a once per step at N = 1024
    launches = check_launches({"streaming_cholesky": steps, "blocked_cholesky": len(out[1024]["losses"])},
                              "exact_dense")["streaming_cholesky"]
    real = chol_stream.streaming_cholesky
    chol_stream.streaming_cholesky = chol_stream.streaming_cholesky_plain
    try:
        plain = exact_largen.dense(ns=(K5_N,), dev="cuda")[K5_N]
    finally:
        chol_stream.streaming_cholesky = real
    check(chol_stream.LAUNCHES == launches, "the plain run launched no K5")
    got, ref = out[K5_N]["losses"], plain["losses"]
    rel = np.abs(got - ref) / np.abs(ref)
    for n, o in out.items():
        check(bool(np.isfinite(o["losses"]).all()) and o["losses"][-1] < o["losses"][0], f"N = {n}: losses fall")
    check(float(rel[0]) <= DENSE_RTOL_STEP0, f"step-0 loss vs the plain run: {rel[0]:.3g} <= {DENSE_RTOL_STEP0}")
    check(float(rel[-1]) <= DENSE_RTOL_STEP19, f"step-19 loss vs the plain run: {rel[-1]:.3g} <= {DENSE_RTOL_STEP19}")
    emit("exact_dense", steps=steps, launches=launches, ms_per_step={n: o["ms_per_step"] for n, o in out.items()},
         plain_ms_per_step_8192=plain["ms_per_step"], step0_rel_err=float(rel[0]), step19_rel_err=float(rel[-1]),
         losses_8192=got.tolist(), device=dev_name)
    return launches


def phase_seard_ref(seard_spatial, dev):
    """2 splits × 51 steps of the seard fit against the pinned JAX losses."""
    from nonstationary_precip_tpu_torch.data.dataprep import load_csv
    from nonstationary_precip_tpu_torch.train.vmapped import fit_splits
    from nonstationary_precip_tpu_torch.utils.config import DATASET_DIR

    ref = np.load(EXACT_REF)
    cfg = seard_spatial.default_config().parse_args(["--device", "cuda"])
    data = load_csv(DATASET_DIR / "uib_spatial.csv")
    splits = [seard_spatial.make_split(data, int(rs), cfg, torch.float32, dev) for rs in ref["seard_splits"]]
    x = np.stack([s[1][0].cpu().numpy() for s in splits]).astype(np.float64)
    y = np.stack([s[1][1].cpu().numpy() for s in splits]).astype(np.float64)
    sums = np.stack([x.sum(axis=(-1, -2)), (x * x).sum(axis=(-1, -2)), y.sum(axis=-1)], axis=-1)
    # the pinned sums are of the float64 splits, the port's of their f32 values
    check(np.allclose(sums, ref["seard_checksums"], rtol=1e-6, atol=1e-4), "the pinned run trains the port's splits")
    steps = ref["seard_losses"].shape[0]
    reset_launches()
    res = fit_splits([s[0] for s in splits], seard_spatial._loss, [s[1][0] for s in splits],
                     [s[1][1] for s in splits], lr=float(ref["seard_lr"]), num_steps=steps)
    check_launches({}, "seard_ref")
    rel = np.abs(res.losses - ref["seard_losses"]) / np.abs(ref["seard_losses"])
    check(float(rel[0].max()) <= SEARD_RTOL_STEP0, f"step-0 losses vs JAX: {rel[0].max():.3g} <= {SEARD_RTOL_STEP0}")
    check(float(rel[-1].max()) <= SEARD_RTOL_STEP50,
          f"step-{steps - 1} losses vs JAX: {rel[-1].max():.3g} <= {SEARD_RTOL_STEP50}")
    emit("seard_ref", splits=ref["seard_splits"].tolist(), steps=steps, step0_rel_err=float(rel[0].max()),
         step50_rel_err=float(rel[-1].max()), max_rel_err=float(rel.max()))


def phase_seard(seard_spatial, dev_name: str):
    """The whole 10-split experiment inside its RESULTS band; no kernel of
    the port's runs at N = 315."""
    reset_launches()
    out = seard_spatial.run(seard_spatial.default_config().parse_args(["--device", "cuda"]))
    check_launches({}, "seard")
    losses = out["losses"]
    check(bool(np.isfinite(losses).all()) and bool((losses[-1] < losses[0]).all()), "every split's loss falls")
    check(out["rmse"] <= SEARD_RMSE, f"10-split RMSE {out['rmse']:.4f} <= {SEARD_RMSE}")
    check(out["nlpd"] <= SEARD_NLPD, f"10-split NLPD {out['nlpd']:.4f} <= {SEARD_NLPD}")
    emit("seard", steps=out["steps"], rmse=out["rmse"], nlpd=out["nlpd"], rmses=out["rmses"].tolist(),
         nlpds=out["nlpds"].tolist(), steps_per_s=out["steps_per_s"], train_seconds=out["train_seconds"],
         wall_seconds=out["wall_seconds"], device=dev_name)


def phase_temporal(temporal, dev_name: str):
    """The whole 2000-step experiment inside its RESULTS band; no kernel of
    the port's runs at N = 273."""
    reset_launches()
    out = temporal.run(temporal.default_config().parse_args(["--device", "cuda"]))
    check_launches({}, "temporal")
    check(bool(np.isfinite(out["losses"]).all()) and out["losses"][-1] < out["losses"][0], "the loss falls")
    check(out["rmse"] <= TEMPORAL_RMSE, f"RMSE {out['rmse']:.4f} <= {TEMPORAL_RMSE}")
    check(out["nlpd"] <= TEMPORAL_NLPD, f"NLPD {out['nlpd']:.4f} <= {TEMPORAL_NLPD}")
    emit("temporal", steps=out["steps"], rmse=out["rmse"], nlpd=out["nlpd"], raw_rmse=out["raw_rmse"],
         steps_per_s=out["steps_per_s"], train_seconds=out["train_seconds"], wall_seconds=out["wall_seconds"],
         device=dev_name)


def phase_exact_lazy_ref(exact_largen):
    """The matrix-free ExactGP at the pinned run's N on its data and probe
    draws: the losses at steps 0 and 19 against JAX's."""
    ref = np.load(EXACT_REF)
    out = exact_largen.lazy(n=int(ref["lazy_n"]), steps=int(ref["lazy_steps"]), rank=int(ref["lazy_rank"]),
                            iters=int(ref["lazy_iters"]), block=int(ref["lazy_block"]), lr=float(ref["lazy_lr"]),
                            dev="cuda", data=(ref["lazy_x"], ref["lazy_y"]),
                            probe_noise=(ref["lazy_u1"], ref["lazy_u2"]))
    losses = out["losses"]
    rel = np.abs(losses - ref["lazy_losses"]) / np.abs(ref["lazy_losses"])
    check(losses.shape == ref["lazy_losses"].shape, f"loss trace shape {losses.shape}")
    check(float(rel[0]) <= LAZY_RTOL_STEP0, f"step-0 loss vs JAX: {rel[0]:.3g} <= {LAZY_RTOL_STEP0}")
    check(float(rel[-1]) <= LAZY_RTOL_STEP19, f"step-19 loss vs JAX: {rel[-1]:.3g} <= {LAZY_RTOL_STEP19}")
    emit("exact_lazy_ref", n=int(ref["lazy_n"]), step0_rel_err=float(rel[0]), step19_rel_err=float(rel[-1]),
         losses=losses.tolist(), jax_losses=ref["lazy_losses"].tolist(), loss_lazy=out["loss_lazy"],
         jax_loss_lazy=float(ref["lazy_loss_lazy"]), loss_dense=out["loss_dense"],
         jax_loss_dense=float(ref["lazy_loss_dense"]), relres_solve=out["relres_solve"])


def phase_exact_lazy(exact_largen, dev_name: str):
    """The matrix-free gate at N = 16384, counting K6's launches."""
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    out = exact_largen.lazy(n=LARGEN_N, dev="cuda")
    steps, iters = len(out["losses"]), out["iters"]
    # one K6 launch per mBCG iteration: in each training step, in the
    # trained-pose diagnostics, in the lazy loss the oracle is held to and in
    # the predictive's solve; K5 is not on this path (N > 8192, and the
    # oracle is float64)
    launches = check_launches({"rbf_matvec": (steps + 3) * iters}, "exact_lazy")["rbf_matvec"]
    check(out["relres_solve"] <= GATE_RELRES, f"relres_solve {out['relres_solve']:.3g} <= {GATE_RELRES}")
    check(out["loss_rel_diff"] <= GATE_LOSS_REL, f"loss vs dense {out['loss_rel_diff']:.3g} <= {GATE_LOSS_REL}")
    check(out["grad_cosine"] >= GATE_COSINE, f"gradient cosine {out['grad_cosine']:.5f} >= {GATE_COSINE}")
    for name in ("kernel.base.raw_lengthscale", "kernel.raw_outputscale", "likelihood.raw_noise"):
        g = out["grads_lazy"][name]
        check(bool(np.isfinite(g).all() and (g != 0).all()), f"the lazy gradient of {name} is finite and non-zero")
    check(not out["diag"]["broke"], "no mBCG breakdown")
    check(out["pred_mean_max_abs_diff"] <= LAZY_MEAN_TOL,
          f"predictive mean vs dense {out['pred_mean_max_abs_diff']:.3g} <= {LAZY_MEAN_TOL}")
    emit("exact_lazy", n=LARGEN_N, steps=steps, iters=iters, launches=launches, relres_solve=out["relres_solve"],
         diag=out["diag"], loss_lazy=out["loss_lazy"], loss_dense=out["loss_dense"],
         loss_rel_diff=out["loss_rel_diff"], grad_cosine=out["grad_cosine"],
         grads_lazy={k: v.tolist() for k, v in out["grads_lazy"].items()},
         grads_dense={k: v.tolist() for k, v in out["grads_dense"].items()},
         pred_mean_max_abs_diff=out["pred_mean_max_abs_diff"], loss_first=float(out["losses"][0]),
         loss_last=float(out["losses"][-1]), ms_per_step=out["ms_per_step"], train_seconds=out["train_seconds"],
         wall_seconds=out["wall_seconds"], peak_mem_gb=torch.cuda.max_memory_allocated() / 2**30, device=dev_name)
    return out, launches


def phase_k6(matvec, exact_largen, lazy_out, dev):
    """K6 against its plain version and float64 on the gate's trained
    payload (N = 16384, R = 9) and a column-chunked R = 200; times."""
    from nonstationary_precip_tpu_torch.kernels.stationary import _sq_dist

    x, _, _ = exact_largen.lazy_data(LARGEN_N)
    with torch.no_grad():
        z = (x.to(dev) / lazy_out["model"].kernel.base.lengthscale).contiguous()
    gen = torch.Generator().manual_seed(43)
    v = torch.randn(LARGEN_N, 9, generator=gen).to(dev)
    rows, wide_r = K6_WIDE
    vw = torch.randn(LARGEN_N, wide_r, generator=gen).to(dev)
    errs = {}

    def compare(name, z1, z2, vv):
        k = matvec.rbf_gram_matvec_cuda(z1, z2, vv)
        again = matvec.rbf_gram_matvec_cuda(z1, z2, vv)
        p = matvec.rbf_gram_matvec_plain(z1, z2, vv)
        z1d, z2d, vd = z1.double(), z2.double(), vv.double()
        ref = torch.cat([torch.exp(-0.5 * _sq_dist(z1d[i:i + 2048], z2d)) @ vd for i in range(0, z1.shape[0], 2048)])
        torch.cuda.synchronize()
        check(bool(torch.isfinite(k).all()), f"K6 {name} finite")
        check(torch.equal(k, again), f"K6 {name} bitwise repeatable")
        ek, ep = float((k.double() - ref).abs().max()), float((p.double() - ref).abs().max())
        largest = float(ref.abs().max())
        check(ek <= 2 * ep + K6_FLOOR * largest,
              f"K6 {name} vs float64 {ek:.3g} within 2x the plain version's {ep:.3g} (+{K6_FLOOR} x {largest:.3g})")
        errs[name] = {"kernel_vs_f64": ek, "plain_vs_f64": ep, "largest": largest,
                      "max_abs_err": float((k - p).abs().max())}

    compare("trained", z, z, v)
    compare("wide", z[:rows].contiguous(), z, vw)
    t = timed_pair(lambda: matvec.rbf_gram_matvec_cuda(z, z, v), lambda: matvec.rbf_gram_matvec_plain(z, z, v),
                   N_TIMED_GRAM)
    ops = matvec.rbf_matvec_ops(LARGEN_N, LARGEN_N, 2, 9)
    # reads z1, z2 and V once, writes the output
    fp32_ms, fp32_by = bound(ops, 4 * (2 * LARGEN_N * 2 + 2 * LARGEN_N * 9))
    # the SFU: 16 operations a clock an SM at the card's maximum SM clock
    clock_hz = sm_clock_mhz() * 1e6
    sfu_ops = matvec.rbf_matvec_sfu_ops(LARGEN_N, LARGEN_N)
    sfu_ms = sfu_ops / (16 * torch.cuda.get_device_properties(dev).multi_processor_count * clock_hz) * 1e3
    b_ms, b_by = max((fp32_ms, fp32_by), (sfu_ms, "operations"))
    out = {"max_abs_err": max(e["max_abs_err"] for e in errs.values()), "bound_ms": b_ms, "bound_by": b_by, **t}
    emit("k6", shape=[LARGEN_N, LARGEN_N, 2, 9], wide=[rows, LARGEN_N, 2, wide_r], errors=errs, ops=ops,
         sfu_ops=sfu_ops, fp32_bound_ms=fp32_ms, sfu_bound_ms=sfu_ms, sm_clock_mhz=clock_hz / 1e6,
         timed_calls=2 * N_TIMED_GRAM, **out)
    out["call"] = lambda: matvec.rbf_gram_matvec_cuda(z, z, v)
    return out


def gibbs_row_launches(rows: int, steps: int) -> dict:
    """What the Gibbs rows launch: for each row, K8 once per step (the MAP
    loss), and in the predictive K9 three times (k_xx, k_ss, k_sx), K10a
    once (its factor) and K11 once (L⁻¹K_xs); nothing else (the prior's
    Cholesky stacks are 3-D and stay on the library)."""
    return {"gibbs_chol_solve_fused": rows * steps, "gibbs_gram": 3 * rows, "blocked_cholesky": rows,
            "blocked_trsm": rows}


def phase_gibbs_dense_ref(exact_largen, dev):
    """The Gibbs row at N = 1024 from the pinned JAX run's init: its losses
    at steps 0 and 19 against JAX's; then the predictive at the pinned
    trained pose against JAX's."""
    ref = np.load(GIBBS_REF)
    n, steps = int(ref["n"]), int(ref["steps"])
    init = {k[len("init."):]: ref[k] for k in ref.files if k.startswith("init.")}
    x, y = exact_largen.gibbs_data((n,))[n]
    check(np.array_equal(x.numpy(), ref["x"]) and np.allclose(y.numpy(), ref["y"], rtol=0, atol=1e-6),
          "the pinned run's data is the port's draw")
    reset_launches()
    out = exact_largen.gibbs_dense(ns=(n,), steps=steps, dev="cuda", init=init)[n]
    check_launches(gibbs_row_launches(1, steps), "gibbs_dense_ref")
    losses = out["losses"]
    rel = np.abs(losses - ref["losses"]) / np.abs(ref["losses"])
    check(losses.shape == ref["losses"].shape, f"loss trace shape {losses.shape}")
    check(float(rel[0]) <= GIBBS_RTOL_STEP0, f"step-0 loss vs JAX: {rel[0]:.3g} <= {GIBBS_RTOL_STEP0}")
    check(float(rel[-1]) <= GIBBS_RTOL_STEP19, f"step-19 loss vs JAX: {rel[-1]:.3g} <= {GIBBS_RTOL_STEP19}")
    model = out["model"]
    with torch.no_grad():
        model.log_ell.copy_(torch.as_tensor(ref["log_ell"], device=dev))
    pred = exact_largen.gibbs_predict(model, x.to(dev), y.to(dev))
    dmean = float(np.abs(pred["mean"].cpu().numpy() - ref["pred_mean"]).max())
    dvar = float(np.abs(pred["var"].cpu().numpy() - ref["pred_var"]).max())
    check(dmean <= GIBBS_MEAN_ATOL, f"predictive mean vs JAX {dmean:.3g} <= {GIBBS_MEAN_ATOL}")
    check(dvar <= GIBBS_VAR_ATOL, f"predictive variance vs JAX {dvar:.3g} <= {GIBBS_VAR_ATOL}")
    emit("gibbs_dense_ref", n=n, step0_rel_err=float(rel[0]), step19_rel_err=float(rel[-1]), losses=losses.tolist(),
         jax_losses=ref["losses"].tolist(), pred_mean_max_abs_diff=dmean, pred_var_max_abs_diff=dvar,
         rmse=pred["rmse"], jax_rmse=float(ref["rmse"]), nlpd=pred["nlpd"], jax_nlpd=float(ref["nlpd"]))


def predictive_times(exact_largen, out) -> dict:
    """Per row: the trained predictive's time (CUDA events around blocks of
    10 calls, median; the call ends in host reads of RMSE and NLPD) and,
    from one profiled call, K11's span on the device, from its first
    launch's start to its last one's end (its launches overlap while each
    waits for the one before, so their durations do not add up), and its
    share of the predictive."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    res = {}
    for n, o in out.items():
        x, y = (t.cuda() for t in exact_largen.gibbs_data((n,))[n])

        def predict():
            return exact_largen.gibbs_predict(o["model"], x, y)

        ms = statistics.median(block_times_ms(predict, 20))
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            predict()
            torch.cuda.synchronize()
        k11 = [e.time_range for e in prof.events() if e.device_type == DeviceType.CUDA and "trsm_row_kernel" in e.name]
        check(len(k11) == -(-n // 128), f"N = {n}: the predictive launched K11's kernel {len(k11)} times")
        span = (max(t.end for t in k11) - min(t.start for t in k11)) / 1e3
        res[n] = {"ms": ms, "k11_ms": span, "k11_share": span / ms}
    return res


def phase_gibbs_dense(exact_largen, dev_name: str):
    """bench_scaling.py's Gibbs rows (N = 1024 and 1280, 20 Adam steps each)
    and their predictive, counting the launches of K8, K9, K10a and K11;
    then the predictive's time and K11's share of it."""
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    out = exact_largen.gibbs_dense(ns=GIBBS_NS, dev="cuda")
    steps = len(out[GIBBS_NS[0]]["losses"])
    launches = check_launches(gibbs_row_launches(len(GIBBS_NS), steps), "gibbs_dense")
    for n, o in out.items():
        check(bool(np.isfinite(o["losses"]).all()) and o["losses"][-1] < o["losses"][0], f"N = {n}: losses fall")
        check(np.isfinite(o["rmse"]) and np.isfinite(o["nlpd"]), f"N = {n}: RMSE and NLPD finite")
        check(bool(torch.isfinite(o["mean"]).all() and (o["var"] > 0).all()), f"N = {n}: predictive finite")
    peak_gb = torch.cuda.max_memory_allocated() / 2**30
    emit("gibbs_dense", steps=steps, launches=launches, ms_per_step={n: o["ms_per_step"] for n, o in out.items()},
         predictive=predictive_times(exact_largen, out),
         rmse={n: o["rmse"] for n, o in out.items()}, nlpd={n: o["nlpd"] for n, o in out.items()},
         loss_first={n: float(o["losses"][0]) for n, o in out.items()},
         loss_last={n: float(o["losses"][-1]) for n, o in out.items()}, peak_mem_gb=peak_gb, device=dev_name)
    return out, launches


def gibbs_payloads(exact_largen, out, dev) -> dict:
    """{name: (x, ℓ, y, s², σ², x_q, ℓ_q)}: the Gibbs rows at init (ℓ = 0.3)
    and at their trained pose, with the grid and its conditioned field
    (what the loss and the predictive hand the kernels), and a ragged
    N = 1000 at init."""
    pay = {}
    xq = exact_largen.gibbs_grid().to(dev)
    for n in (*GIBBS_NS, GIBBS_RAGGED):
        x, y = (t.to(dev) for t in exact_largen.gibbs_data((n,))[n])
        init, _ = exact_largen.gibbs_model(x)
        poses = {"init": init, **({"trained": out[n]["model"]} if n in out else {})}
        for pose, m in poses.items():
            with torch.no_grad():
                ell = torch.exp(m.log_ell).contiguous()
                ellq = m.prior.conditional_mean(xq, (x, ell)).contiguous()
            pay[f"{n}_{pose}"] = (x, ell, y, m.outputscale.detach(), m.likelihood.noise.detach(), xq, ellq)
    return pay


def rel_err(a: torch.Tensor, ref: torch.Tensor) -> float:
    """Largest entrywise error of ``a`` from the float64 ``ref``, relative
    to ``ref``'s largest entry."""
    return float((a.double() - ref).abs().max() / ref.abs().max())


def check_f64(what: str, kernel: torch.Tensor, plain: torch.Tensor, ref: torch.Tensor, floor: float) -> dict:
    """The kernel's error from float64 within twice the plain f32 version's
    plus ``floor`` (both relative to the largest float64 entry)."""
    check(bool(torch.isfinite(kernel).all()), f"{what} finite")
    ek, ep = rel_err(kernel, ref), rel_err(plain, ref)
    check(ek <= 2 * ep + floor, f"{what} vs float64 {ek:.3g} within 2x the plain version's {ep:.3g} (+{floor})")
    return {"kernel_vs_f64": ek, "plain_vs_f64": ep, "max_abs_err": float((kernel - plain).abs().max())}


def slice_field_payloads(spatial_gibbs, dev) -> dict:
    """{name: (x_all, ℓ_all, x_train, ℓ_train)}: the slice's field
    prediction's payloads (its last split's 316 train sites and all 394
    sites, ℓ at the sites from the prior's conditional mean, as
    ``GibbsExactGP.posterior`` makes them) at the split's init ℓ
    (``init``) and at ℓ_train = exp(0.3·N(0, 1)) (``random_ell``)."""
    from nonstationary_precip_tpu_torch.data.datasets import load_uib_spatial
    from nonstationary_precip_tpu_torch.train.config import ExperimentConfig

    _, x, y = load_uib_spatial()
    xn = (x - x.mean(0)) / x.std(0, ddof=1)
    yn = (y - y.mean()) / y.std(ddof=1)
    cfg = ExperimentConfig(device="cuda")
    model, (x_tr, _, _, _) = spatial_gibbs.make_split(xn, yn, cfg.num_splits - 1, cfg, torch.float32, dev)
    x_all = torch.as_tensor(xn, dtype=torch.float32, device=dev)
    gen = torch.Generator().manual_seed(71)
    out = {}
    with torch.no_grad():
        ell_init = torch.exp(model.log_ell)
        for pose, ell in (("init", ell_init),
                          ("random_ell", torch.exp(0.3 * torch.randn(ell_init.shape, generator=gen)).to(dev))):
            ell = ell.contiguous()
            out[pose] = (x_all, model.prior.conditional_mean(x_all, (x_tr, ell)).contiguous(), x_tr, ell)
    return out


def k9_stack_payloads(spatial_gibbs, spatio_temporal, dev) -> dict:
    """{name: (x1, ℓ1, x2, ℓ2)}: the Grams K9 takes on this slice's paths,
    at ℓ = exp(log 0.3 + 0.3·N(0, 1)) at the inducing inputs (or the
    slice's training rows) and the prior's conditional mean at the rows:
    the exact slice's stacked (10, 316²), the sparse Gibbs model's stacked
    (10, 316 × 250) and (10, 250²) on its k-means z, and the ST model's 2-D
    172 × 100 and 215 × 100 (its step's and its field's K_xz)."""
    from nonstationary_precip_tpu_torch.data.datasets import load_uib_spatial, spatio_temporal_month_split
    from nonstationary_precip_tpu_torch.train.config import ExperimentConfig

    _, x, y = load_uib_spatial()
    xn = (x - x.mean(0)) / x.std(0, ddof=1)
    yn = (y - y.mean()) / y.std(ddof=1)
    cfg = ExperimentConfig(inference="sparse", device="cuda")
    splits = [spatial_gibbs.make_split(xn, yn, s, cfg, torch.float32, dev) for s in range(cfg.num_splits)]
    gen = torch.Generator().manual_seed(73)

    def field(shape):
        return torch.exp(np.log(0.3) + 0.3 * torch.randn(shape, generator=gen)).to(dev).contiguous()

    with torch.no_grad():
        xt = torch.stack([s[1][0] for s in splits])
        z = torch.stack([s[0].z for s in splits]).contiguous()
        prior = splits[0][0].prior
        ell_z, ell_t = field(z.shape), field(xt.shape)
        ell_x = prior.conditional_mean(xt, (z, ell_z)).contiguous()
        st_cfg = spatio_temporal.default_config().parse_args(
            ["--model", "Non-Stationary", "--num_inducing", str(ST_INDUCING), "--device", "cuda"])
        x_tr, _, _, _, _, _, x_all, _ = spatio_temporal_month_split()
        x_tr, x_all = (torch.as_tensor(a, dtype=torch.float32, device=dev) for a in (x_tr, x_all))
        st = spatio_temporal.make_model(st_cfg, x_tr)
        zs = st.z[:, [1, 2]].contiguous()
        ell_zs = field(zs.shape)
        out = {"slice_316x316": (xt, ell_t, xt, ell_t), "sparse_316x250": (xt, ell_x, z, ell_z),
               "sparse_250x250": (z, ell_z, z, ell_z)}
        for name, xq in (("st_172x100", x_tr), ("st_215x100", x_all)):
            xs = xq[:, [1, 2]].contiguous()
            out[name] = (xs, st.prior.conditional_mean(xs, (zs, ell_zs)).contiguous(), zs, ell_zs)
    shapes = {k: (tuple(v[0].shape), tuple(v[2].shape)) for k, v in out.items()}
    check(shapes["sparse_316x250"] == ((10, 316, 2), (10, 250, 2)) and shapes["st_172x100"] == ((172, 2), (100, 2))
          and shapes["st_215x100"] == ((215, 2), (100, 2)), f"K9's path payloads {shapes}")
    return out


def phase_k9(gibbs_gram, matvec, spatial_gibbs, payloads, dev, stacks):
    """K9 and its plain version against float64 on the predictive's three
    Grams at each payload, on the slice's field prediction's three Grams
    and on a random D = 3 pair (the per-dim element); bitwise repeat; at
    D = 2 its first K9_ONE_HOT columns bitwise equal to K2's product with
    the one-hot I[:, :K9_ONE_HOT] (the two compute one element); times at
    N = 1280."""
    from nonstationary_precip_tpu_torch.kernels.gibbs import gibbs_gram_reference

    errs = {}
    gen = torch.Generator().manual_seed(67)

    def random_pair(shape, d):
        out = []
        for n in shape:
            out += [torch.rand(n, d, generator=gen) * 4 - 2, torch.exp(0.3 * torch.randn(n, d, generator=gen))]
        return tuple(t.to(dev) for t in out)

    cases = {f"{name}_{pair}": args for name, (x, ell, _, _, _, xq, ellq) in payloads.items()
             for pair, args in (("xx", (x, ell, x, ell)), ("sx", (xq, ellq, x, ell)), ("ss", (xq, ellq, xq, ellq)))}
    for pose, (xa, ella, xt, ellt) in slice_field_payloads(spatial_gibbs, dev).items():
        cases.update({f"slice_{pose}_xx": (xt, ellt, xt, ellt), f"slice_{pose}_ss": (xa, ella, xa, ella),
                      f"slice_{pose}_sx": (xa, ella, xt, ellt)})
    check(tuple(cases["slice_init_sx"][0].shape) == (394, 2) and tuple(cases["slice_init_xx"][0].shape) == (316, 2),
          "the slice's field payloads are 394 and 316 sites")
    cases["d3_random"] = random_pair(K9_D3, 3)
    cases["d2_ragged"] = random_pair(K9_D2_RAGGED, 2)
    for name, args in cases.items():
        k = gibbs_gram.gibbs_gram_cuda(*args)
        again = gibbs_gram.gibbs_gram_cuda(*args)
        p = gibbs_gram_reference(*args)
        ref = gibbs_gram_reference(*(a.double() for a in args))
        torch.cuda.synchronize()
        check(torch.equal(k, again), f"K9 {name} bitwise repeatable")
        errs[name] = check_f64(f"K9 {name}", k, p, ref, DENSE_FLOOR)
        if args[0].shape[1] == 2:
            eye = torch.eye(args[2].shape[0], K9_ONE_HOT, device=dev)
            k2 = matvec.gibbs_gram_matvec_cuda(*args, eye)
            torch.cuda.synchronize()
            gap = float((k[:, :K9_ONE_HOT] - k2).abs().max())
            check(torch.equal(k[:, :K9_ONE_HOT], k2),
                  f"K9 {name}: columns 0..{K9_ONE_HOT - 1} bitwise K2's (largest gap {gap:.3g})")
    # the stacked entry (F-P5) and the ST model's pairs: one launch a call
    # (the wrapper's count; the CUDA launches are traced in `traced`), each
    # member bit for bit the 2-D launch on it, float64 as above
    stack_errs = {}
    for name, args in stacks.items():
        before = gibbs_gram.LAUNCHES
        k = gibbs_gram.gibbs_gram_cuda(*args)
        check(gibbs_gram.LAUNCHES == before + 1, f"K9 {name}: one launch a call")
        again = gibbs_gram.gibbs_gram_cuda(*args)
        p = gibbs_gram_reference(*args)
        ref = gibbs_gram_reference(*(a.double() for a in args))
        torch.cuda.synchronize()
        check(torch.equal(k, again), f"K9 {name} bitwise repeatable")
        if args[0].ndim == 3:
            for t in range(args[0].shape[0]):
                one = gibbs_gram.gibbs_gram_cuda(*(a[t] for a in args))
                check(torch.equal(k[t], one), f"K9 {name}: member {t} bitwise the 2-D launch on it")
        stack_errs[name] = check_f64(f"K9 {name}", k, p, ref, DENSE_FLOOR)
    n = GIBBS_NS[-1]
    x, ell = payloads[f"{n}_trained"][:2]
    t = timed_pair(lambda: gibbs_gram.gibbs_gram_cuda(x, ell, x, ell), lambda: gibbs_gram_reference(x, ell, x, ell),
                   N_TIMED)
    # d2_elem's 15 operations an element; reads the four (N, D) payloads, writes the Gram
    b_ms, b_by = bound(gibbs_gram.gram_ops(n, n, 2), gibbs_gram.gram_bytes(n, n, 2))
    errs.update(stack_errs)
    out = {"max_abs_err": max(e["max_abs_err"] for e in errs.values()), "bound_ms": b_ms, "bound_by": b_by, **t}
    sa = stacks[K9_STACK_TIMED]
    nt, n1, n2 = sa[0].shape[0], sa[0].shape[1], sa[2].shape[1]
    ts = timed_pair(lambda: gibbs_gram.gibbs_gram_cuda(*sa), lambda: gibbs_gram_reference(*sa), N_TIMED)
    sb_ms, sb_by = bound(nt * gibbs_gram.gram_ops(n1, n2, 2), nt * gibbs_gram.gram_bytes(n1, n2, 2))
    stacked = {"name": K9_STACK_TIMED, "ms": ts["ms"], "plain_ms": ts["plain_ms"], "bound_ms": sb_ms, "bound_by": sb_by}
    emit("k9", n=n, errors=errs, k2_one_hot_columns=K9_ONE_HOT, timed_calls=2 * N_TIMED, stacked=stacked, **out)
    return {**out, "stacked": stacked, "stacked_call": lambda: gibbs_gram.gibbs_gram_cuda(*sa),
            "call": lambda: gibbs_gram.gibbs_gram_cuda(x, ell, x, ell)}


def phase_k10a(chol_blocked, payloads, dev):
    """K10a, its plain version and torch.linalg.cholesky against float64 on
    the predictive's noisy train Gram at each payload (``chol_errors``), and
    bitwise repeat; a rank-30 matrix through safe_cholesky's retry; times at
    N = 1280."""
    from nonstationary_precip_tpu_torch.kernels.gibbs import gibbs_gram_reference
    from nonstationary_precip_tpu_torch.ops.linalg import safe_cholesky

    def gram(x, ell, s2, noise):
        with torch.no_grad():
            return s2 * gibbs_gram_reference(x, ell, x, ell) + noise * torch.eye(x.shape[0], device=dev)

    errs, mats = {}, {}
    for name, (x, ell, _, s2, noise, _, _) in payloads.items():
        a = mats[name] = gram(x, ell, s2, noise)
        errs[name] = chol_errors(f"K10a {name}", chol_blocked.blocked_cholesky_cuda, a,
                                 {"plain": chol_blocked.blocked_cholesky_plain})
        check(torch.equal(chol_blocked.blocked_cholesky_cuda(a), chol_blocked.blocked_cholesky_cuda(a)),
              f"K10a {name} bitwise repeatable")
    gen = torch.Generator().manual_seed(47)
    lr = torch.randn(GIBBS_RAGGED, 30, generator=gen, dtype=torch.float64)
    bad = (lr @ lr.T).float().to(dev)
    check(not bool(torch.isfinite(chol_blocked.blocked_cholesky_cuda(bad)).all()),
          "K10a on a rank-30 input: non-finite")
    before = chol_blocked.LAUNCHES
    fixed = safe_cholesky(bad)
    tries = chol_blocked.LAUNCHES - before
    check(bool(torch.isfinite(fixed).all()) and tries >= 2,
          f"safe_cholesky retried through K10a ({tries} calls), finite")
    n = GIBBS_NS[-1]
    a = mats[f"{n}_trained"]
    t = timed_pair(lambda: chol_blocked.blocked_cholesky_cuda(a), lambda: chol_blocked.blocked_cholesky_plain(a),
                   N_TIMED)
    lib = block_times_ms(lambda: torch.linalg.cholesky(a), N_TIMED) + block_times_ms(
        lambda: torch.linalg.cholesky(a), N_TIMED)
    b_ms, b_by = bound(n**3 / 3, 4 * 2 * n * n)  # N³/3 operations; reads A, writes L
    out = {"max_abs_err": max(e["max_abs_err"] for e in errs.values()), "library_ms": statistics.median(lib),
           "bound_ms": b_ms, "bound_by": b_by, **t}
    emit("k10a", n=n, errors=errs, retry_calls=tries, timed_calls=2 * N_TIMED, **out)
    return out


def backward_ratio(l: torch.Tensor, b: torch.Tensor, x: torch.Tensor) -> float:
    """Largest entrywise |L·X − B| / (γ_{N+1}|L||X| + (N + 1)·2⁻¹⁴⁹), in
    float64: the bound of forward substitution (Higham, Theorem 8.5), with
    gradual underflow's term as in ``chol_bound_ratio``."""
    l64, x64 = l.double(), x.double()
    n = l.shape[-1]
    gamma = (n + 1) * 2.0**-24 / (1 - (n + 1) * 2.0**-24)
    return float(((l64 @ x64 - b.double()).abs() / (gamma * (l64.abs() @ x64.abs()) + (n + 1) * 2.0**-149)).max())


def cuda_launches(fn, name: str, sessions: int = 3) -> int:
    """Device kernels whose name holds ``name`` in one call of ``fn``, as
    torch.profiler traces them: the most over ``sessions`` traced calls.  A
    session can come back short of records (an H100 run traced K9's one
    launch as 0 where every other session read 1), never long, so the
    largest reading is the call's."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    counts = []
    for _ in range(sessions):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        counts.append(sum(e.count for e in prof.key_averages() if name in e.key and e.device_time_total > 0))
    return max(counts)


def phase_k11(trsm, payloads, dev):
    """K11 and its plain version against float64 on L⁻¹K_xs of the
    predictive (the factor of the noisy train Gram, the 256 grid columns)
    and on K = 70 random columns at each payload; bitwise repeat; the
    backward-error ratios of K11 (held ≤ 1) and of solve_triangular; times
    at N = 1280, K = 256 and 70; the CUDA launches of one call."""
    from nonstationary_precip_tpu_torch.kernels.gibbs import gibbs_gram_reference

    gen = torch.Generator().manual_seed(53)
    errs, cases = {}, {}
    for name, (x, ell, _, s2, noise, xq, ellq) in payloads.items():
        with torch.no_grad():
            a = s2 * gibbs_gram_reference(x, ell, x, ell) + noise * torch.eye(x.shape[0], device=dev)
            l = torch.linalg.cholesky(a)
            cases[f"{name}_256"] = (l, (s2 * gibbs_gram_reference(xq, ellq, x, ell)).mT)
        cases[f"{name}_70"] = (l, torch.randn(x.shape[0], K11_WIDTHS[1], generator=gen).to(dev))
    for name, (l, b) in cases.items():
        xk = trsm.trsm_cuda(l, b)
        again = trsm.trsm_cuda(l, b)
        p = trsm.trsm_plain(l, b)
        ref = torch.linalg.solve_triangular(l.double(), b.double(), upper=False)
        torch.cuda.synchronize()
        check(torch.equal(xk, again), f"K11 {name} bitwise repeatable")
        errs[name] = check_f64(f"K11 {name}", xk, p, ref, DENSE_FLOOR)
        errs[name].update(bound_ratio=backward_ratio(l, b, xk), library_bound_ratio=backward_ratio(l, b, p))
        check(errs[name]["bound_ratio"] <= 1.0,
              f"K11 {name} backward error within γ_(N+1)|L||X|: ratio {errs[name]['bound_ratio']:.3g} <= 1")
    n = GIBBS_NS[-1]
    times = {}
    for k in K11_WIDTHS:
        l, b = cases[f"{n}_trained_{k}"]
        t = timed_pair(lambda: trsm.trsm_cuda(l, b), lambda: trsm.trsm_plain(l, b), N_TIMED)
        lib = block_times_ms(lambda: torch.linalg.solve_triangular(l, b, upper=False), N_TIMED)
        b_ms, b_by = bound(n * n * k, 4 * (n * n + 2 * n * k))  # N²K operations; reads L and B, writes X
        times[k] = {**t, "library_ms": statistics.median(lib), "bound_ms": b_ms, "bound_by": b_by,
                    "cuda_launches": cuda_launches(lambda: trsm.trsm_cuda(l, b), "trsm_row_kernel")}
        check(times[k]["cuda_launches"] == -(-n // trsm.BLOCK), f"K11: {times[k]['cuda_launches']} launches a call")
    k = K11_WIDTHS[0]
    out = {"max_abs_err": max(e["max_abs_err"] for e in errs.values()),
           **{key: times[k][key] for key in ("ms", "plain_ms", "library_ms", "bound_ms", "bound_by", "cuda_launches")}}
    emit("k11", n=n, k=k, errors=errs, times=times, timed_calls=2 * N_TIMED, **out)
    return out


def device_kernels(fn, calls: int = 1) -> list:
    """(name, start µs, end µs) of every device kernel in ``calls`` calls of
    ``fn`` after one untraced call, in order of start, as torch.profiler
    traces them."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    return sorted(((e.name, e.time_range.start, e.time_range.end) for e in prof.events()
                   if e.device_type == DeviceType.CUDA and "kernel" in e.name), key=lambda k: k[1])


def k8_errors(gibbs_fused, name: str, x, ell, y, s2, noise, rung: int = 1) -> dict:
    """K8 and its plain version on one payload: both take attempt ``rung``,
    L is lower triangular, L and α are held to float64 by ``check_f64``
    (K8_FLOOR), and at rung 1 L's backward error to γ_(N+1)|L||Lᵀ|
    (``chol_bound_ratio``)."""
    from nonstationary_precip_tpu_torch.kernels.gibbs import gibbs_gram_reference

    lk, ak, state = gibbs_fused.gibbs_chol_solve_cuda(x, ell, y, s2, noise)
    lp, ap, tries = gibbs_fused.gibbs_chol_solve_plain(x, ell, y, s2, noise)
    extra = gibbs_fused.EXTRA_JITTER[rung - 1]
    k = s2.double() * gibbs_gram_reference(*(t.double() for t in (x, ell, x, ell)))
    a64 = k + (noise + extra).double() * torch.eye(x.shape[0], dtype=torch.float64, device=x.device)
    l64 = torch.linalg.cholesky(a64)
    al64 = torch.linalg.solve_triangular(l64, y.double()[:, None], upper=False)[:, 0]
    torch.cuda.synchronize()
    got = int(state[0])
    check(got == tries == rung, f"K8 {name}: attempt {got}, the plain version's {tries}, want {rung}")
    check(bool((torch.triu(lk, 1) == 0).all()), f"K8 {name} L lower triangular")
    out = {"L": check_f64(f"K8 {name} L", lk, lp, l64, K8_FLOOR["L"]),
           "alpha": check_f64(f"K8 {name} alpha", ak, ap, al64, K8_FLOOR["alpha"]), "attempt": got}
    if rung == 1:
        ratio = chol_bound_ratio(lk, a64)
        check(ratio <= 1.0, f"K8 {name} backward error within γ_(N+1)|L||Lᵀ|: ratio {ratio:.3g} <= 1")
        out.update(bound_ratio=ratio, plain_bound_ratio=chol_bound_ratio(lp, a64))
    return out


def phase_k8(gibbs_fused, payloads, dev):
    """K8 and its plain version against float64 on the MAP loss's payloads
    (the Gibbs rows at init and trained, the ragged N = 1000), each L also
    held to the backward-error bound γ_(N+1)|L||Lᵀ| (``chol_bound_ratio``,
    K10a's); a payload on which the ladder fires, against the plain
    version's ladder; bitwise repeat; times at N = 1024 and 1280, with the
    CUDA launches of one call and the span of the happy path's empty
    attempts 2 and 3 on the device (torch.profiler)."""
    errs = {}
    for name, (x, ell, y, s2, noise, _, _) in payloads.items():
        errs[name] = k8_errors(gibbs_fused, name, x, ell, y, s2, noise)
    # the ladder: every row twice and no noise, so s²K is singular; the
    # first attempt fails, the second (extra 1e-4) holds
    x, ell, y, s2, _, _, _ = payloads[f"{GIBBS_NS[0]}_init"]
    half = x.shape[0] // 2
    xd, ed = x[:half].repeat(2, 1), ell[:half].repeat(2, 1)
    errs["ladder"] = k8_errors(gibbs_fused, "ladder", xd, ed, torch.sin(xd[:, 0]), s2, torch.zeros_like(s2), rung=2)
    x, ell, y, s2, noise, _, _ = payloads[f"{GIBBS_NS[-1]}_trained"]
    runs = [gibbs_fused.gibbs_chol_solve_cuda(x, ell, y, s2, noise)[:2] for _ in range(2)]
    check(all(torch.equal(a, b) for a, b in zip(*runs)), "K8 bitwise repeatable")
    times = {}
    for n in GIBBS_NS:
        x, ell, y, s2, noise, _, _ = payloads[f"{n}_trained"]
        t = timed_pair(lambda: gibbs_fused.gibbs_chol_solve_cuda(x, ell, y, s2, noise),
                       lambda: gibbs_fused.gibbs_chol_solve_plain(x, ell, y, s2, noise), N_TIMED)
        # reads x, ℓ (N, 2) and y; writes L and α
        b_ms, b_by = bound(gibbs_fused.fused_ops(n, 2), 4 * (4 * n + n + n * n + n))
        # K8's own kernels (not the wrapper's zero fills): 3 N_pad / 128 an
        # attempt, attempts 2 and 3 empty on the happy path
        ks = [k for k in device_kernels(lambda: gibbs_fused.gibbs_chol_solve_cuda(x, ell, y, s2, noise))
              if any(f in k[0] for f in ("build_kernel", "diag_kernel", "panel_kernel", "syrk_kernel",
                                         "commit_kernel"))]
        want = 3 * (3 * (-(-n // gibbs_fused.BLOCK)))
        check(len(ks) == want, f"K8 at N = {n}: {len(ks)} CUDA launches a call, want {want}")
        first_commit = next(end for name, _, end in ks if "commit_kernel" in name)
        times[n] = {**t, "bound_ms": b_ms, "bound_by": b_by, "cuda_launches": len(ks),
                    "empty_attempts_us": ks[-1][2] - first_commit, "attempt1_us": first_commit - ks[0][1]}
    out = {"max_abs_err": max(max(e["L"]["max_abs_err"], e["alpha"]["max_abs_err"]) for e in errs.values()),
           **{k: times[GIBBS_NS[0]][k] for k in ("ms", "plain_ms", "bound_ms", "bound_by", "cuda_launches")}}
    emit("k8", n=GIBBS_NS[0], errors=errs, times=times, timed_calls=2 * N_TIMED, **out)
    return out


def k10b_errors(chol_inv, a: torch.Tensor, name: str) -> dict:
    """K10b and its plain version on one stack against float64; bitwise
    repeat.  Neither retries, so each may fail on a member that is singular
    to f32 working accuracy: a member either version leaves non-finite must
    fall short of Higham's sufficient condition for an f32 Cholesky to run
    to completion (Thm 10.7, 20·N^{3/2}·u·κ₂(A) < 1); the members both
    factor are held to float64."""
    l, li = chol_inv.chol_inv_grid_cuda(a)
    again = chol_inv.chol_inv_grid_cuda(a)
    pl, pli = chol_inv.chol_inv_batched_plain(a)
    torch.cuda.synchronize()
    check(all(torch.equal(x.view(torch.int32), y.view(torch.int32)) for x, y in zip((l, li), again)),
          f"K10b {name} bitwise repeatable (NaNs included)")

    def finite(*ts):
        return torch.stack([torch.isfinite(t).flatten(1).all(1) for t in ts]).all(0)

    kfin, pfin = finite(l, li), finite(pl, pli)
    n = a.shape[-1]
    failed = ~(kfin & pfin)
    if bool(failed.any()):
        ev = torch.linalg.eigvalsh(a[failed].double())
        kappa = ev[:, -1] / ev[:, 0].clamp_min(1e-300)
        check(bool((kappa.isinf() | (ev[:, 0] <= 0) | (20 * n**1.5 * 2.0**-24 * kappa >= 1)).all()),
              f"K10b {name}: the members left non-finite ({failed.nonzero()[:, 0].tolist()}) are singular to f32 "
              f"(κ₂ {kappa.tolist()})")
    check(bool((torch.triu(l[kfin], 1) == 0).all() and (torch.triu(li[kfin], 1) == 0).all()),
          f"K10b {name} lower triangular")
    ok = kfin & pfin
    check(int(ok.sum()) > 0, f"K10b {name}: some member factored")
    l64 = torch.linalg.cholesky(a[ok].double())
    eye = torch.eye(n, dtype=torch.float64, device=a.device)
    li64 = torch.linalg.solve_triangular(l64, eye.expand_as(l64), upper=False)
    return {"L": check_f64(f"K10b {name} L", l[ok], pl[ok], l64, K10B_FLOOR["L"]),
            "Linv": check_f64(f"K10b {name} L⁻¹", li[ok], pli[ok], li64,
                              K10B_FLOOR["Linv_kzz" if name.startswith("kzz") else "Linv"]),
            "kernel_nonfinite": (~kfin).nonzero()[:, 0].tolist(), "plain_nonfinite": (~pfin).nonzero()[:, 0].tolist()}


def phase_k10b(chol_inv, svgp_precompute, spatial_gibbs, dgp_model, dev):
    """K10b against float64 and its plain version on the deep GP's K_zz
    stacks at its init and trained poses (50 × 250²), the slice's Gram (10 ×
    316²), (3, 512) and a ragged (2, 130); a non-PD member beside healthy
    ones; bitwise equal to K1 with its retry off (the same kernel) on the
    K_zz and slice stacks; the entry ``chol_inv_batched`` forward and
    backward, counted; times of K10b and its plain version at the K_zz,
    slice and (3, 512) shapes."""
    from nonstationary_precip_tpu_torch.models.gibbs_gp import noisy_gibbs_gram
    from nonstationary_precip_tpu_torch.train.config import ExperimentConfig
    from nonstationary_precip_tpu_torch.train.vmapped import stack_modules
    from nonstationary_precip_tpu_torch.data.datasets import load_uib_spatial
    from nonstationary_precip_tpu_torch.data.dataprep import load_csv
    from nonstationary_precip_tpu_torch.experiments import deepgp_spatial
    from nonstationary_precip_tpu_torch.utils.config import DATASET_DIR

    def kzz(model):
        z, ell, s2, _ = k4_payload(model)
        with torch.no_grad():
            return svgp_precompute.gram_zz_plain(z, ell, s2).contiguous()

    cfg = deepgp_spatial.default_config().parse_args(["--num_epochs", "1", "--device", "cuda"])
    data = load_csv(DATASET_DIR / "uib_spatial.csv")
    init_model = stack_modules([deepgp_spatial.prep_split(data, s, cfg, torch.float32, dev)[0]
                                for s in range(cfg.num_splits)])
    _, x, y = load_uib_spatial()
    xn = (x - x.mean(0)) / x.std(0, ddof=1)
    yn = (y - y.mean()) / y.std(ddof=1)
    scfg = ExperimentConfig(device="cuda")
    splits = [spatial_gibbs.make_split(xn, yn, s, scfg, torch.float32, dev) for s in range(10)]
    with torch.no_grad():
        slice_gram = noisy_gibbs_gram(stack_modules([s[0] for s in splits]),
                                      torch.stack([s[1][0] for s in splits])).contiguous()
    gen = torch.Generator().manual_seed(59)

    def spd(b, n):
        m = torch.randn(b, n, n, generator=gen, dtype=torch.float64)
        return (m @ m.mT / n + 0.5 * torch.eye(n, dtype=torch.float64)).float().to(dev)

    payloads = {"kzz_init": kzz(init_model), "kzz_trained": kzz(dgp_model), "slice": slice_gram,
                **{f"random_{b}x{n}": spd(b, n) for b, n in K10B_RANDOM}}
    check(tuple(payloads["kzz_trained"].shape) == (50, 250, 250), "the deep GP's K_zz stack is 50 × 250²")
    errs = {name: k10b_errors(chol_inv, a, name) for name, a in payloads.items()}

    # a negative-definite member beside healthy ones: non-finite there, the
    # others bitwise as without it
    good = spd(3, 250)
    bad = good.clone()
    bad[1] = -bad[1]
    lg, lig = chol_inv.chol_inv_grid_cuda(good)
    lb, lib = chol_inv.chol_inv_grid_cuda(bad)
    torch.cuda.synchronize()
    check(not bool(torch.isfinite(lb[1]).all()), "K10b's non-PD member non-finite")
    check(torch.equal(lg[[0, 2]], lb[[0, 2]]) and torch.equal(lig[[0, 2]], lib[[0, 2]]),
          "K10b's healthy members bitwise as in the run without the non-PD one")

    # K1's kernel with its retry off, launched through K1's wrapper: the same bits
    for name in K10B_AS_K1:
        got = chol_inv.chol_inv_grid_cuda(payloads[name])
        k1 = chol_inv.chol_inv_batched_cuda(payloads[name], max_tries=0)[:2]
        torch.cuda.synchronize()
        check(all(torch.equal(x.view(torch.int32), y.view(torch.int32)) for x, y in zip(got, k1)),
              f"K10b {name} bitwise K1's with max_tries = 0")

    # the entry, as a caller reaches it: forward and backward, counted
    a = payloads["kzz_trained"].clone().requires_grad_()
    reset_launches()
    l, li = chol_inv.chol_inv_batched(a)
    (l.sum() + li.sum()).backward()
    launches = check_launches({"chol_inv_grid": 1}, "k10b entry")["chol_inv_grid"]
    check(a.grad is not None and a.grad.shape == a.shape, "the entry's backward reached the stack")

    times = {}
    for name in ("kzz_trained", "slice", "random_3x512"):
        a = payloads[name]
        t = timed_pair(lambda: chol_inv.chol_inv_grid_cuda(a), lambda: chol_inv.chol_inv_batched_plain(a), N_TIMED)
        b, n, _ = a.shape
        # 2N³/3 operations a member (Cholesky and triangular inverse, N³/3
        # each); reads A once, writes L and L⁻¹
        b_ms, b_by = bound(b * 2 * n**3 / 3, 4 * 3 * b * n * n)
        times[name] = {**t, "bound_ms": b_ms, "bound_by": b_by, "shape": [b, n]}
    out = {"max_abs_err": max(max(e["L"]["max_abs_err"], e["Linv"]["max_abs_err"]) for e in errs.values()),
           "launches": launches, **{k: times["kzz_trained"][k] for k in ("ms", "plain_ms", "bound_ms", "bound_by")}}
    emit("k10b", errors=errs, as_k1_bitwise=list(K10B_AS_K1), times=times, timed_calls=2 * N_TIMED, **out)
    big = payloads["random_3x512"]
    return {**out, "call": lambda: chol_inv.chol_inv_grid_cuda(big)}


def phase_k10c(chol_stream, exact_largen, dev):
    """K10c against float64, its plain version, K5 and potrf on the dense
    run's Grams at N = 8192 and 4096 and a ragged SPD N = 1000, and bitwise
    repeat; a rank-30 matrix comes out non-finite; the entry ``streaming_cholesky_v1`` forward
    and backward, counted; times of all four at 8192 and 4096."""
    gen = torch.Generator().manual_seed(61)
    b = torch.randn(K10C_RAGGED, K10C_RAGGED, generator=gen, dtype=torch.float64)
    payloads = {**{f"dense_gram_{n}": dense_gram(exact_largen, n, dev) for n in K10C_NS},
                f"ragged_spd_{K10C_RAGGED}": (b @ b.T / K10C_RAGGED + torch.eye(K10C_RAGGED,
                                                                             dtype=torch.float64)).float().to(dev)}
    others = {"plain": chol_stream.streaming_cholesky_v1_plain, "k5": chol_stream.streaming_cholesky_cuda}
    errs = {name: chol_errors(f"K10c {name}", chol_stream.streaming_cholesky_v1_cuda, a, others)
            for name, a in payloads.items()}
    for name, a in payloads.items():  # fixed-order sums, no atomics
        check(torch.equal(chol_stream.streaming_cholesky_v1_cuda(a), chol_stream.streaming_cholesky_v1_cuda(a)),
              f"K10c {name} bitwise repeatable")
    lr = torch.randn(K10C_RAGGED, 30, generator=gen, dtype=torch.float64)
    check(not bool(torch.isfinite(chol_stream.streaming_cholesky_v1_cuda((lr @ lr.T).float().to(dev))).all()),
          "K10c on a rank-30 input: non-finite")

    a = payloads[f"dense_gram_{K10C_NS[1]}"].clone().requires_grad_()
    reset_launches()
    l = chol_stream.streaming_cholesky_v1(a)
    torch.sum(l * l).backward()  # d/dA of ‖L‖² = tr(A): the identity's symmetric part
    launches = check_launches({"streaming_cholesky_v1": 1}, "k10c entry")["streaming_cholesky_v1"]
    check(bool(torch.isfinite(a.grad).all()), "the entry's backward finite")
    grad_err = float((a.grad - torch.eye(a.shape[-1], device=dev)).abs().max())  # reported: f32 solves in L

    times = {}
    for n in K10C_NS:
        a = payloads[f"dense_gram_{n}"]
        t = timed_pair(lambda: chol_stream.streaming_cholesky_v1_cuda(a),
                       lambda: chol_stream.streaming_cholesky_v1_plain(a), K5_TIMED)
        k5 = block_times_ms(lambda: chol_stream.streaming_cholesky_cuda(a), K5_TIMED)
        lib = block_times_ms(lambda: torch.linalg.cholesky(a), K5_TIMED)
        b_ms, b_by = bound(chol_stream.cholesky_ops(n), 4 * 2 * n * n)  # N³/3 operations; reads A, writes L
        times[n] = {**t, "k5_ms": statistics.median(k5), "library_ms": statistics.median(lib), "bound_ms": b_ms,
                    "bound_by": b_by}
    out = {"max_abs_err": max(e["max_abs_err"] for e in errs.values()), "launches": launches,
           **{k: times[K10C_NS[0]][k] for k in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "k5_ms")}}
    emit("k10c", errors=errs, times=times, entry_grad_vs_identity=grad_err, timed_calls=2 * K5_TIMED, **out)
    return out


def exp_f64_sass_ops(matvec) -> dict:
    """The FP64 instructions of K12's ``exp_f64_probe`` in the SASS of its
    library (cuobjdump), counted by ``matvec.fp64_sass_ops``: those that
    run on arguments within the range check, and apart those of the block
    it branches over."""
    from nonstationary_precip_tpu_torch.ops.cuda_build import nvcc

    lib = matvec._lib_f64._name
    sass = subprocess.run([str(Path(nvcc()).parent / "cuobjdump"), "-sass", lib], capture_output=True, text=True,
                          timeout=120, check=True).stdout
    body = re.search(r"Function : \S*exp_f64_probe\S*\n(.*?)(?=\n\s*Function :|\Z)", sass, re.S).group(1)
    return matvec.fp64_sass_ops(body)


def k12_payload(quickstart, dev):
    """The quickstart's 16384 rows (float64) and its prior dim 0's
    (ℓ, s²), the operands of K12 on the gibbs_mf path."""
    x = torch.tensor(quickstart.problem(K12_SHAPES[0][1])[0], dtype=torch.float64, device=dev)
    prior = quickstart.build_model(x.float()).prior
    ell, s2 = prior._dim_params()[0]
    return x, (ell, s2)


def phase_k12(matvec, quickstart, dev):
    """K12 against its plain version at K12_SHAPES (K12_ULPS's criterion),
    bitwise repeat, the exp probe against torch.exp and its SASS count
    against ``matvec.EXP_F64_OPS`` (the path that runs: every operand's
    scaled distance, bounded by its box, within ``matvec.EXP_F64_RANGE``);
    times of each shape, kernel against plain, and the FP64 bound
    (``matvec.se_f64_matvec_ops`` over 34 TFLOP/s)."""
    from nonstationary_precip_tpu_torch.priors.lognormal_process import _COND_JITTER

    sass = exp_f64_sass_ops(matvec)
    check(sass["ops"] == matvec.EXP_F64_OPS, f"K12 exp's SASS: {sass} FP64 operations == {matvec.EXP_F64_OPS}")
    gen = torch.Generator().manual_seed(41)
    q = (torch.rand(1 << 16, generator=gen, dtype=torch.float64) * 60).to(dev)
    probe_rel = float(((matvec.exp_f64_probe(q) - torch.exp(-q)) / torch.exp(-q)).abs().max())
    check(probe_rel <= 4 * 2.0**-52, f"K12 exp probe vs torch.exp {probe_rel:.3g} <= 4 eps")
    x, params = k12_payload(quickstart, dev)
    jitter = torch.tensor(_COND_JITTER, dtype=torch.float64, device=dev)
    eps = torch.finfo(torch.float64).eps
    rows, out = {}, {"max_abs_err": 0.0}
    for name, n1, n2, r in K12_SHAPES:
        x1 = x[:n1]
        x2 = None if n2 is None else torch.cat([x, 6 * torch.rand(n2 - x.shape[0], 2, generator=gen,
                                                                    dtype=torch.float64).to(dev) - 3])
        cols = x1 if x2 is None else x2
        sig = jitter if x2 is None else None
        both = torch.cat([x1, cols])
        q_box = float(torch.sum(((both.amax(0) - both.amin(0)) / params[0]) ** 2) / 2)
        check(q_box < matvec.EXP_F64_RANGE, f"K12 {name}: exp's arguments within its range check "
                                            f"({q_box:.3g} < {matvec.EXP_F64_RANGE})")
        v = torch.randn(cols.shape[0], r, generator=gen, dtype=torch.float64).to(dev)
        mv = matvec.make_se_f64_matvec(params, x1, x2, sig)
        k, again = mv(v), mv(v)
        p = matvec.se_f64_matvec_plain(params, x1, cols, v, sig)
        s_abs = matvec.se_f64_matvec_plain(params, x1, cols, v.abs(), sig)
        torch.cuda.synchronize()
        err = (k - p).abs()
        ratio = float((err / (2 * (cols.shape[0] + K12_ULPS) * eps * s_abs)).max())
        check(bool(torch.isfinite(k).all()) and ratio <= 1.0,
              f"K12 {name}: |kernel − plain| within 2(N + {K12_ULPS})·ε·S (ratio {ratio:.3g})")
        check(torch.equal(k, again), f"K12 {name} bitwise repeatable")
        t = timed_pair(lambda: mv(v), lambda: matvec.se_f64_matvec_plain(params, x1, cols, v, sig), K12_TIMED)
        ops = matvec.se_f64_matvec_ops(n1, cols.shape[0], 2, r)
        nbytes = 8 * (2 * (n1 + cols.shape[0]) + cols.shape[0] * r + n1 * r)
        b_ops, b_bytes = ops / matvec.PEAK_F64 * 1e3, nbytes / PEAK_BYTES * 1e3
        rows[name] = {"shape": [n1, cols.shape[0], 2, r], "max_abs_err": float(err.max()),
                      "max_rel_err": float(err.max() / p.abs().max()), "bound_ratio": ratio, "ops": ops,
                      "exp_arg_box": q_box, "bound_ms": max(b_ops, b_bytes),
                      "bound_by": "operations" if b_ops >= b_bytes else "bytes",
                      "timed_calls": 2 * K12_TIMED, **t}
        out["max_abs_err"] = max(out["max_abs_err"], float(err.max()))
    emit("k12", rows=rows, exp_sass=sass, exp_probe_rel_err=probe_rel, peak_f64=matvec.PEAK_F64)
    head = rows[K12_SHAPES[0][0]]
    return {**out, **{k: head[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by")}}


def prior_launches(dims: int, *solves: int, means: int = 0) -> int:
    """K12's launches: one an mBCG iteration of each prior solve (``solves``,
    the iterations each dim's solves ran, summed over the run's solves: each
    takes at most 16 right-hand sides, one launch), and one a dim for each
    conditional mean (``means``)."""
    return dims * sum(solves) + dims * means


def gibbs_mf_launches(iters: int, steps: int, post_iters: int, extra_steps: int = 0,
                      queries: tuple = ()) -> dict:
    """K2 once per mBCG iteration of the data term (``iters`` a step) and of
    the posterior's solves (``post_iters`` each), K3 once per step's
    backward; ``extra_steps`` untimed-then-timed steps and ``queries``
    variance solves (their iteration counts) beside."""
    return {"gibbs_matvec": (steps + extra_steps) * iters + sum(post_iters) + sum(queries),
            "gibbs_panel_grads": steps + extra_steps}


def phase_gibbs_mf_ref(quickstart, dev):
    """The matrix-free Gibbs flow at N = 2048 from the pinned JAX run's data,
    prior SLQ probes and per-step probes: the prior's SLQ logdet against the
    float64 dense one, the losses at steps 0 and 19 against JAX's (the
    prior's constant logdet the pinned run's), then the posterior mean and
    variance at the pinned trained pose against the float64 dense ones."""
    ref = np.load(GIBBS_MF_REF)
    n, steps, block = int(ref["n"]), int(ref["steps"]), int(ref["block"])
    rank, prior_rank = int(ref["rank"]), int(ref["prior_rank"])
    x, y, xs = (torch.tensor(ref[k], device=dev) for k in ("x", "y", "xs"))
    prior_noise = [(torch.tensor(ref["prior_u1"][d], device=dev), torch.tensor(ref["prior_u2"][d], device=dev))
                   for d in range(2)]
    step_noise = [(torch.tensor(ref["step_u1"][i], device=dev), torch.tensor(ref["step_u2"][i], device=dev))
                  for i in range(steps)]
    model = quickstart.build_model(x)
    reset_launches()
    lpc, logdet = model.prior_pre_matrixfree(x, prior_noise, rank=prior_rank, block=block,
                                             max_iters=quickstart.PRIOR_ITERS, tol=1e-8)
    with torch.no_grad():
        dense_logdet = model.prior.gram_pre(x.double())[1]
    logdet_err = float(((logdet - dense_logdet).abs() / dense_logdet.abs()).max())
    check(logdet_err <= GIBBS_MF_LOGDET_RTOL,
          f"prior SLQ logdet vs float64 dense {logdet_err:.3g} <= {GIBBS_MF_LOGDET_RTOL}")
    pinned = torch.tensor(ref["prior_logdet"], device=dev)
    losses, _ = quickstart.fit(model, x, y, (lpc, pinned), step_noise, refresh=int(ref["refresh"]), rank=rank,
                               block=block)
    rel = np.abs(losses - ref["losses"]) / np.abs(ref["losses"])
    check(bool(np.isfinite(losses[[0, -1]]).all()) and bool(torch.isfinite(logdet).all()),
          "compared losses and logdet finite")
    check(float(rel[0]) <= GIBBS_MF_RTOL_STEP0, f"step-0 loss vs JAX: {rel[0]:.3g} <= {GIBBS_MF_RTOL_STEP0}")
    check(float(rel[-1]) <= GIBBS_MF_RTOL_STEP19, f"step-19 loss vs JAX: {rel[-1]:.3g} <= {GIBBS_MF_RTOL_STEP19}")
    with torch.no_grad():
        model.log_ell.copy_(torch.tensor(ref["log_ell"], device=dev))
        model.raw_outputscale.copy_(torch.tensor(ref["raw_outputscale"], device=dev))
        model.likelihood.raw_noise.copy_(torch.tensor(ref["raw_noise"], device=dev))
    post = model.posterior_matrixfree(x, y, xs, (lpc, pinned), block=block, max_iters=quickstart.PRIOR_ITERS,
                                      tol=1e-8, precond_rank=rank)
    # K12: the hoist's SLQ, each step's quadratic and the posterior's
    # conditioning solve, PRIOR_ITERS each (none stops early), and its mean
    k12 = prior_launches(2, quickstart.PRIOR_ITERS, steps * quickstart.PRIOR_ITERS, quickstart.PRIOR_ITERS, means=1)
    launches = check_launches({**gibbs_mf_launches(quickstart.ITERS, steps, (quickstart.PRIOR_ITERS,)),
                               "se_matvec_f64": k12}, "gibbs_mf_ref")
    with torch.no_grad():
        dense = model.double().posterior(x.double(), y.double(), xs.double())
    dm, dv = dense.mean.cpu().numpy(), torch.diagonal(dense.cov).cpu().numpy()
    errs = {"mean": float(np.abs(post.mean.cpu().numpy() - dm).max()),
            "var": float(np.abs(torch.diagonal(post.cov).cpu().numpy() - dv).max()),
            "jax_mean": float(np.abs(ref["post_mean"] - dm).max()), "jax_var": float(np.abs(ref["post_var"] - dv).max()),
            "mean_vs_jax": float(np.abs(post.mean.cpu().numpy() - ref["post_mean"]).max())}
    for what, tol in (("mean", GIBBS_MF_MEAN_ATOL), ("var", GIBBS_MF_VAR_ATOL)):
        check(errs[what] <= tol, f"posterior {what} vs float64 dense {errs[what]:.3g} <= {tol} "
                                 f"(the JAX run's: {errs[f'jax_{what}']:.3g})")
    emit("gibbs_mf_ref", n=n, step0_rel_err=float(rel[0]), step19_rel_err=float(rel[-1]), losses=losses.tolist(),
         jax_losses=ref["losses"].tolist(), prior_logdet=logdet.tolist(), jax_prior_logdet=ref["prior_logdet"].tolist(),
         dense_prior_logdet_f64=dense_logdet.tolist(), prior_logdet_rel_err=logdet_err, posterior_errors=errs,
         launches=launches)
    return launches


def gibbs_mf_field_grads(quickstart, out: dict) -> dict:
    """The field's gradient of ``loss_matrixfree`` at the quickstart's
    trained pose, term by term, against float64 dense references.  Prior
    term: ``log_prob_matrixfree``'s (as the loss calls it) against the exact
    gradient of ``prior.log_prob``.  Data term: the whole matrix-free field
    gradient less the prior's, against the same estimator on the same probes
    with exact solves (dense Cholesky): ∂/∂ℓ of −(½αᵀKα − (1/2R)Σⱼ sⱼᵀK rⱼ)/N,
    α = K⁻¹y, sⱼ = K⁻¹zⱼ, rⱼ = P⁻¹zⱼ for the probes zⱼ ~ N(0, P), summed over
    row panels of K through autograd.  Then their sum against the whole."""
    import copy

    from nonstationary_precip_tpu_torch.kernels.gibbs import packed_gibbs_cross
    from nonstationary_precip_tpu_torch.ops.bbmm import sample_precond_probes, woodbury_precond

    model, x, y, block = out["model"], out["x"], out["y"], out["block"]
    n, field = x.shape[0], model.log_ell.numel()
    x64, ell64 = x.double(), model.log_ell.detach().double()

    def compare(g, ref):
        return {"cosine": float(g @ ref / (g.norm() * ref.norm())), "rel": float((g - ref).norm() / ref.norm())}

    ell = model.log_ell.detach().clone().requires_grad_()
    lp = model.prior.log_prob_matrixfree(x, ell, out["prior_pre"], block=block, max_iters=quickstart.PRIOR_ITERS,
                                         tol=1e-6)
    g_prior_mf = torch.autograd.grad(-lp / n, ell)[0].double().reshape(-1)
    prior64 = copy.deepcopy(model.prior).double()
    ellp = ell64.clone().requires_grad_()
    with torch.no_grad():
        chols = prior64.gram_chol(x64)
    g_prior = torch.autograd.grad(-prior64.log_prob(x64, ellp, chols) / n, ellp)[0].reshape(-1)
    del chols

    raw, s2 = model.raw_outputscale.detach().double(), model.likelihood.noise.detach().double()
    lpc = out["lpc"].double()
    z = sample_precond_probes(lpc, s2, *(u.double() for u in out["check_noise"]))
    rights = woodbury_precond(lpc, s2)(z)
    cross = packed_gibbs_cross(x.shape[1])
    with torch.no_grad():
        aug = torch.cat([x64, ell64], dim=1)
        k = torch.cat([cross(raw, aug[i:i + block], aug) for i in range(0, n, block)])
        k.diagonal().add_(s2)
        chol = torch.linalg.cholesky(k)
        del k
        sol = torch.cholesky_solve(torch.cat([y.double()[:, None], z], dim=1), chol)
        del chol
    alpha, solves = sol[:, 0], sol[:, 1:]
    elld = ell64.clone().requires_grad_()
    for i in range(0, n, block):
        aug = torch.cat([x64, elld], dim=1)
        panel = cross(raw, aug[i:i + block], aug)
        sur = (0.5 * alpha[i:i + block] @ (panel @ alpha)
               - 0.5 / z.shape[1] * torch.sum(solves[i:i + block] * (panel @ rights)))
        (-sur / n).backward()
    g_data = elld.grad.reshape(-1)
    g_mf = out["grad_mf"][:field]
    res = {"prior": compare(g_prior_mf, g_prior), "data": compare(g_mf - g_prior_mf, g_data),
           "field": compare(g_mf, g_prior + g_data)}
    for term, band in (("prior", GIBBS_MF_PRIOR_GRAD), ("data", GIBBS_MF_DATA_GRAD)):
        check(res[term]["cosine"] >= band["cosine"] and res[term]["rel"] <= band["rel"],
              f"{term} term's field gradient vs float64: cosine {res[term]['cosine']:.6f} >= {band['cosine']}, "
              f"relative error {res[term]['rel']:.3g} <= {band['rel']}")
    check(res["field"]["cosine"] >= GATE_COSINE,
          f"field gradient vs float64 (same probes): cosine {res['field']['cosine']:.6f} >= {GATE_COSINE}")
    return res


def phase_gibbs_mf(quickstart, dev_name: str):
    """The matrix-free Gibbs flow at the gate's size (the quickstart's run):
    the matrix-free loss against the dense MAP loss, prior included, the
    gradient cosine, the field's gradient term by term
    (``gibbs_mf_field_grads``), the trained-pose relres, the state's
    mean-only query against the one-shot mean, a finite RMSE; K2's and K3's launches against
    what the code implies, K9 once (the dense oracle's Gram) and no other
    kernel; the times of a step, its prior term, the hoist, the state and a
    query batch."""
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    out = quickstart.run(n=GIBBS_MF_N, steps=GIBBS_MF_STEPS, refresh=4, block=2048, rank=150, prior_rank=50,
                         dev="cuda", timings=True)
    wall = time.perf_counter() - t0
    it, post_it = quickstart.ITERS, quickstart.PRIOR_ITERS
    # training steps; the trained-pose loss, its diagnostics; the posterior
    # and the state's α solve; 4 timed steps (one warm-up) and 4 variance
    # queries at the auto budget (16 at this N); the dense oracle's Gram
    want = gibbs_mf_launches(it, GIBBS_MF_STEPS + 1, (it, post_it, post_it), extra_steps=4, queries=(16,) * 4)
    # K12, none of whose solves stops early: the hoist's SLQ, the steps'
    # quadratics (the trained-pose loss and the 4 timed steps among them),
    # the one-shot posterior's conditioning solve, the state's (its
    # prior_max_iters, 64), the 4 timed prior terms; a mean a dim for the
    # posterior, the state's query and the 8 timed queries
    k12 = prior_launches(2, post_it, (GIBBS_MF_STEPS + 1 + 4) * post_it, post_it, 64, 4 * post_it, means=10)
    launches = check_launches({**want, "gibbs_gram": 1, "se_matvec_f64": k12}, "gibbs_mf")
    check(out["loss_rel_diff"] <= GATE_LOSS_REL, f"loss vs dense {out['loss_rel_diff']:.3g} <= {GATE_LOSS_REL}")
    check(out["grad_cosine"] >= GATE_COSINE, f"gradient cosine {out['grad_cosine']:.5f} >= {GATE_COSINE}")
    check(out["diag"]["relres_solve"] <= GATE_RELRES,
          f"trained-pose relres {out['diag']['relres_solve']:.3g} <= {GATE_RELRES}")
    check(not out["diag"]["broke"], "no mBCG breakdown at the trained pose")
    check(out["drift"] < GIBBS_MF_DRIFT, f"state mean vs one-shot {out['drift']:.3g} < {GIBBS_MF_DRIFT}")
    check(bool(np.isfinite(out["losses"]).all()) and np.isfinite(out["rmse"]), "losses and RMSE finite")
    field_grads = gibbs_mf_field_grads(quickstart, out)
    emit("gibbs_mf", n=GIBBS_MF_N, steps=GIBBS_MF_STEPS, launches=launches, field_grads=field_grads,
         **{k: out[k] for k in ("loss_mf", "loss_dense", "loss_rel_diff", "grad_cosine", "field_grad_cosine",
                                "drift", "rmse", "state_alpha_relres", "ms_per_step", "train_seconds",
                                "hoist_seconds", "posterior_seconds", "state_seconds", "step_ms", "prior_ms",
                                "prior_share", "query_mean_ms", "query_var_ms")},
         relres_solve=out["diag"]["relres_solve"], diag=out["diag"], prior_logdet=out["prior_logdet"].tolist(),
         loss_first=float(out["losses"][0]), loss_last=float(out["losses"][-1]), wall_seconds=wall,
         peak_mem_gb=torch.cuda.max_memory_allocated() / 2**30, device=dev_name)
    return launches


def in_band(row: str, out: dict) -> tuple:
    """Check ``out``'s RMSE and NLPD against ``row``'s band; (RMSE, NLPD)."""
    r_max, n_max = BANDS[row]
    check(np.isfinite(out["rmse"]) and out["rmse"] <= r_max, f"{row}: RMSE {out['rmse']:.4f} <= {r_max}")
    check(np.isfinite(out["nlpd"]) and out["nlpd"] <= n_max, f"{row}: NLPD {out['nlpd']:.4f} <= {n_max}")
    return out["rmse"], out["nlpd"]


def phase_gibbs_sparse(spatial_gibbs, dev_name: str):
    """``spatial_gibbs --inference sparse --max_iters 2000``: 10 splits ×
    316 rows, M = 250, z and the field training.  Its band; K9 twice a step
    (the stacked (10, 316 × 250) K_xz and (10, 250²) K_zz), four times in
    the evaluation (train and test roots) and four in the last split's field
    (2-D), and no other kernel."""
    from nonstationary_precip_tpu_torch.train.config import ExperimentConfig

    steps = SPARSE_STEPS
    cfg = ExperimentConfig(lr=0.01, max_iters=5000).parse_args(
        ["--max_iters", str(steps), "--inference", "sparse", "--device", "cuda"])
    with tempfile.TemporaryDirectory() as out_dir:
        os.environ["NSGP_RESULTS_DIR"] = out_dir
        reset_launches()
        out = spatial_gibbs.run(cfg)
        got = check_launches({"gibbs_gram": 2 * steps + 8}, "gibbs_sparse")
        field = np.loadtxt(out["csv"], delimiter=",", skiprows=1)
    losses = out["losses"]
    check(losses.shape == (steps, 10) and bool(np.isfinite(losses).all()), f"loss trace {losses.shape}, finite")
    check(bool((losses[-1] < losses[0]).all()), "every split's final loss below its step-0 loss")
    check(field.shape == (394, 4) and bool(np.isfinite(field).all()), f"field CSV {field.shape}, finite")
    rmse, nlpd = in_band("gibbs_spatial_sparse_10split", out)
    emit("gibbs_sparse", steps=steps, launches=got["gibbs_gram"], k9_launches_a_step=2, rmse=rmse, nlpd=nlpd,
         steps_per_s=out["steps_per_s"], train_seconds=out["train_seconds"], wall_seconds=out["wall_seconds"],
         jax_rmse_nlpd=[0.2659, -0.0928], device=dev_name)
    return got["gibbs_gram"]


def phase_spatio_temporal(spatiotemporal_stationary, spatio_temporal, dev_name: str):
    """The three spatio-temporal rows at their run_benchmarks.py arguments:
    the exact stationary baseline (Box-Cox, 200 steps) and
    ``spatio_temporal`` at 500 steps, Stationary and Non-Stationary with
    100 inducing inputs.  Each in its band; no kernel but K9 in the
    nonstationary run: its 172 × 100 spatial K_xz once a step, twice in the
    evaluation and four times in the 215-row field (the 100² K_zz and the
    43 × 100 test Grams stay plain, under 128² a Gram, as in JAX)."""
    from nonstationary_precip_tpu_torch.train.config import ExperimentConfig

    rows, k9 = {}, 0
    with tempfile.TemporaryDirectory() as out_dir:
        os.environ["NSGP_RESULTS_DIR"] = out_dir
        for row, run, argv, want in (
                ("spatio_temporal_stationary_exact", spatiotemporal_stationary.run,
                 ExperimentConfig(lr=0.1, max_iters=200).parse_args(["--device", "cuda"]), {}),
                ("spatio_temporal_stationary", spatio_temporal.run, spatio_temporal.default_config().parse_args(
                    ["--model", "Stationary", "--max_iters", str(ST_STEPS), "--device", "cuda"]), {}),
                ("spatio_temporal_nonstationary", spatio_temporal.run, spatio_temporal.default_config().parse_args(
                    ["--model", "Non-Stationary", "--max_iters", str(ST_STEPS), "--num_inducing", str(ST_INDUCING),
                     "--device", "cuda"]), {"gibbs_gram": ST_STEPS + 2 + 4})):
            reset_launches()
            out = run(argv)
            got = check_launches(want, row)
            check(bool(np.isfinite(out["losses"]).all()), f"{row}: every loss finite")
            if "csv" in out:
                field = np.loadtxt(out["csv"], delimiter=",", skiprows=1)
                check(field.shape == (215, 5) and bool(np.isfinite(field).all()), f"{row}: field {field.shape}")
            rmse, nlpd = in_band(row, out)
            k9 += got["gibbs_gram"]
            rows[row] = {"rmse": rmse, "nlpd": nlpd, "steps": out["steps"], "train_seconds": out["train_seconds"],
                         "wall_seconds": out["wall_seconds"], "k9_launches": got["gibbs_gram"]}
    emit("spatio_temporal", rows=rows, jax_rmse_nlpd={"spatio_temporal_stationary_exact": [1.961, 3.257],
                                                      "spatio_temporal_stationary": [2.217, 3.743],
                                                      "spatio_temporal_nonstationary": [2.112, 4.844]},
         device=dev_name)
    return k9


def phase_sgpr(sgpr_bench, chol_blocked, dev, dev_name: str):
    """``sgpr_bench`` at 100 and 1000 iterations (M = 1900, N = 4540), each
    in its band.  No kernel in the fit; the test predictive's joint NLPD
    factors its 1136² covariance through K10a (the dispatch's 768..1280
    window, as in JAX), once unless its jitter ladder fires.  Then K10a on
    the trained 1000-iteration model's covariance against its plain
    version and float64 (``chol_errors``), after the counts are read."""
    rows, k10a = {}, 0
    for iters, row in zip(SGPR_ITERS, ("sgpr_bench_100iter", "sgpr_bench_converged")):
        cfg = sgpr_bench.default_config().parse_args(["--max_iters", str(iters), "--device", "cuda"])
        reset_launches()
        out = sgpr_bench.run(cfg)
        n = launch_counts()["blocked_cholesky"]
        check(n >= 1, f"{row}: the predictive's 1136² Cholesky went through K10a ({n})")
        check_launches({"blocked_cholesky": n}, row)
        check(bool(np.isfinite(out["losses"]).all()), f"{row}: every loss finite")
        rmse, nlpd = in_band(row, out)
        k10a += n
        rows[row] = {"rmse": rmse, "nlpd": nlpd, "steps": out["steps"], "train_seconds": out["train_seconds"],
                     "ms_a_step": 1e3 * out["train_seconds"] / max(out["steps"] - 1, 1),
                     "wall_seconds": out["wall_seconds"], "k10a_launches": n}
    train_x, train_y, test_x, _, _ = sgpr_bench.prepare(cfg, torch.float32, dev)
    with torch.no_grad():
        cov = out["model"].predictive(train_x, train_y, test_x).cov.contiguous()
    check(tuple(cov.shape) == (1136, 1136), f"SGPR's predictive covariance {tuple(cov.shape)}")
    err = chol_errors("K10a sgpr_1136", chol_blocked.blocked_cholesky_cuda, cov,
                      {"plain": chol_blocked.blocked_cholesky_plain})
    emit("sgpr", rows=rows, k10a_errors=err, jax_rmse_nlpd={"sgpr_bench_100iter": [1.4455, 1.7948],
                                                           "sgpr_bench_converged": [1.4441, 1.7855]},
         device=dev_name)
    return k10a, err


def phase_st_dgp(spatiotemporal_dgp, svgp_precompute, dev, dev_name: str):
    """``spatiotemporal_dgp`` (3 → 2 → 2 → 1, M = 250, 200 steps of 172 rows,
    S = 10): its band; K4 once a step and once in the prediction (D ≤ 3);
    K7 never (its gate takes D = 2, in both packages).  Then K4 at the
    stack this path gives it, (5, 250, D = 3) with the D = 2 layers' ghost
    dims, at init and trained: ``k4_errors``' plain-version and float64
    checks (these launches come after the path's counts are read)."""
    from nonstationary_precip_tpu_torch.experiments.field_regression import init_model

    cfg = spatiotemporal_dgp.default_config().parse_args(["--device", "cuda"])
    reset_launches()
    out = spatiotemporal_dgp.run(cfg)
    got = check_launches({"svgp_precompute": out["steps"] + 1}, "st_dgp")
    check(out["steps"] == 200 and bool(np.isfinite(out["losses"]).all()), f"{out['steps']} steps, finite losses")
    rmse, nlpd = in_band("spatiotemporal_dgp", out)
    errs, jitter = {}, {}
    for name, model in (("st_init", init_model(cfg, 3, dev)), ("st_trained", out["model"])):
        args = k4_payload(model)
        shape = (*args[0].shape, args[3].shape[-1])
        check(shape == (5, 250, 3, 501), f"st_dgp's K4 shape {shape}")
        errs[name], jk, jp = k4_errors(svgp_precompute, args)
        jitter[name] = {"kernel": jk.tolist(), "plain": jp.tolist()}
    emit("st_dgp", steps=out["steps"], launches=got, rmse=rmse, nlpd=nlpd, train_seconds=out["train_seconds"],
         wall_seconds=out["wall_seconds"], jax_rmse_nlpd=[1.610, 2.151], k4_errors=errs, k4_jitter=jitter,
         device=dev_name)
    return got["svgp_precompute"], errs


def _pinned_losses(what: str, losses: np.ndarray, ref: np.ndarray, rtol0: float, ref64=None) -> dict:
    """``losses``' steps 0 and 19 against the pinned JAX run's: step 0 to
    ``rtol0``, step 19 to RTOL_STEP50; or, given the pinned float64 run
    ``ref64``, step 19 of each split within twice JAX's float32 distance
    from it plus RTOL_STEP50 of it."""
    rel0 = float(np.max(np.abs(losses[0] - ref[0]) / np.abs(ref[0])))
    rel19 = float(np.max(np.abs(losses[19] - ref[19]) / np.abs(ref[19])))
    check(rel0 <= rtol0, f"{what}: step-0 losses vs JAX {rel0:.3g} <= {rtol0}")
    out = {"step0_rel_err": rel0, "step19_rel_err": rel19}
    if ref64 is None:
        check(rel19 <= RTOL_STEP50, f"{what}: step-19 losses vs JAX {rel19:.3g} <= {RTOL_STEP50}")
        return out
    gap, allowed = np.abs(losses[19] - ref64[19]), 2 * np.abs(ref[19] - ref64[19]) + RTOL_STEP50 * np.abs(ref64[19])
    check(bool((gap <= allowed).all()), f"{what}: step-19 losses from JAX's float64 run {gap.tolist()} within "
                                        f"{allowed.tolist()}")
    return {**out, "step19_gap_to_f64": gap.tolist(), "step19_allowed": allowed.tolist(),
            "jax_f32_gap_to_f64": np.abs(ref[19] - ref64[19]).tolist()}


def phase_sparse_ref(spatial_gibbs, spatio_temporal, sgpr_bench, dev):
    """The three sparse models for 20 Adam steps from the pinned JAX runs'
    z (tests/fixtures/jax_sparse_ref.npz): the sparse Gibbs slice's 10
    splits, the ST nonstationary model (M = 100) and SGPR (M = 1900, whose z
    the port draws itself, bit for bit JAX's); losses at steps 0 and 19
    against JAX's, K9 twice a step in the first, once in the second.  The
    sparse Gibbs slice also: each split's step-0 gradient in z and in the
    field against JAX's, in float32 and float64, and 20 float64 steps with
    z frozen against JAX's float64 run (SPARSE_GRAD_RTOL, SPARSE_F64_RTOL)."""
    from nonstationary_precip_tpu_torch.data.datasets import load_uib_spatial, spatio_temporal_month_split
    from nonstationary_precip_tpu_torch.models.sgpr import SGPR
    from nonstationary_precip_tpu_torch.train.config import ExperimentConfig
    from nonstationary_precip_tpu_torch.train.optim import fit
    from nonstationary_precip_tpu_torch.train.vmapped import fit_splits, stack_modules

    ref = np.load(SPARSE_REF)
    steps = int(ref["steps"])
    out = {}
    _, x, y = load_uib_spatial()
    xn, yn = (x - x.mean(0)) / x.std(0, ddof=1), (y - y.mean()) / y.std(ddof=1)
    cfg = ExperimentConfig(inference="sparse", device="cuda")

    def splits(dtype):
        models, xs, ys = [], [], []
        for s in range(cfg.num_splits):
            model, (x_tr, y_tr, _, _) = spatial_gibbs.make_split(xn, yn, s, cfg, dtype, dev)
            with torch.no_grad():
                model.z.copy_(torch.as_tensor(ref["gibbs.z"][s], dtype=dtype, device=dev))
                model.log_ell_z.copy_(model.prior.init_log_field(model.z))
            models.append(model)
            xs.append(x_tr)
            ys.append(y_tr)
        return models, xs, ys

    for dtype, suffix in ((torch.float32, ""), (torch.float64, "_f64")):
        models, xs, ys = splits(dtype)
        # the step-0 gradients, every split at once, against JAX's
        stacked = stack_modules(models)
        stacked.loss(torch.stack(xs), torch.stack(ys)).sum().backward()
        grads = {}
        for name in ("z", "log_ell_z"):
            got = getattr(stacked, name).grad.double().cpu().numpy()
            want = ref[f"gibbs.grad0.{name}{suffix}"].astype(np.float64)
            rel = (np.linalg.norm((got - want).reshape(len(models), -1), axis=1)
                   / np.linalg.norm(want.reshape(len(models), -1), axis=1))
            grads[name] = rel.tolist()
            tol = SPARSE_GRAD_RTOL[dtype].get(name)
            if tol is not None:
                check(float(rel.max()) <= tol, f"sparse Gibbs {dtype} step-0 gradient in {name} vs JAX's: "
                                               f"{float(rel.max()):.3g} <= {tol} (norm, per split)")
        out[f"gibbs_grad0{suffix}_rel_err"] = grads
        if dtype == torch.float32:
            reset_launches()
            res = fit_splits(models, lambda m, xx, yy: m.loss(xx, yy), xs, ys, lr=0.01, num_steps=steps)
            check_launches({"gibbs_gram": 2 * steps}, "sparse_ref gibbs")
            out["gibbs"] = _pinned_losses("sparse Gibbs", res.losses, ref["gibbs.losses"], RTOL_STEP0_SPARSE_GIBBS,
                                          ref["gibbs.losses_f64"])
        else:  # z frozen: a trajectory float64 runs share (its z-gradient path is held above)
            for model in models:
                model.z.requires_grad_(False)
            res = fit_splits(models, lambda m, xx, yy: m.loss(xx, yy), xs, ys, lr=0.01, num_steps=steps)
            want = ref["gibbs.frozen.losses_f64"]
            rel = np.abs(res.losses - want).max(axis=1) / np.abs(want).max(axis=1)
            for step, tol in ((0, SPARSE_F64_RTOL[0]), (steps - 1, SPARSE_F64_RTOL[1])):
                check(rel[step] <= tol, f"sparse Gibbs float64, z frozen: step-{step} losses vs JAX's "
                                        f"{rel[step]:.3g} <= {tol}")
            out["gibbs_f64_z_frozen"] = {"rel_err_a_step": rel.tolist()}

    st_cfg = spatio_temporal.default_config().parse_args(
        ["--model", "Non-Stationary", "--num_inducing", str(ST_INDUCING), "--device", "cuda"])
    x_tr, y_tr, *_ = spatio_temporal_month_split()
    x_tr, y_tr = (torch.as_tensor(a, dtype=torch.float32, device=dev) for a in (x_tr, y_tr))
    model = spatio_temporal.make_model(st_cfg, x_tr)
    with torch.no_grad():
        model.z.copy_(torch.as_tensor(ref["st.z"], device=dev))
        model.log_ell_z.copy_(model.prior.init_log_field(model.z[:, [1, 2]]))
    reset_launches()
    res = fit(model, lambda m, xx, yy: m.loss(xx, yy), x_tr, y_tr, lr=0.015, num_steps=steps)
    check_launches({"gibbs_gram": steps}, "sparse_ref st")
    out["st"] = _pinned_losses("ST nonstationary", res.losses[:, None], ref["st.losses"][:, None], RTOL_STEP0)

    train_x, train_y, _, _, z = sgpr_bench.prepare(sgpr_bench.default_config(), torch.float32, dev)
    check(np.array_equal(z.cpu().numpy(), ref["sgpr.z"]), "SGPR's z is the pinned JAX run's, bit for bit")
    reset_launches()
    res = fit(SGPR.create(sgpr_bench.make_kernel(torch.float32, dev), z, dtype=torch.float32, device=dev),
              lambda m, xx, yy: m.loss(xx, yy), train_x, train_y, lr=0.05, num_steps=steps)
    check_launches({}, "sparse_ref sgpr")
    out["sgpr"] = _pinned_losses("SGPR", res.losses[:, None], ref["sgpr.losses"][:, None], RTOL_STEP0)
    emit("sparse_ref", steps=steps, **out)
    return out


def serve_launches(serve, cfg, n: int, n_pts: int, executed: int) -> dict:
    """Each kernel's launches in one serve, from the code: ``executed`` Adam
    steps (retried chunks included) on n training rows, then the predictive
    at n_pts query points in fixed chunks of 4096 (1024 matrix-free), the
    tail padded.  K9 takes a Gibbs Gram wherever N₁·N₂ ≥ 128² (its gate at
    D = 2, float32): the exact Gibbs step's noisy Gram (K8's 768..1280 window
    is not entered), its predictive's K_xx, K_ss and K_sx; the
    sparse Gibbs step's K_xz and K_zz and its predictive's two roots; the ST
    model's spatial K_xz and K_zz a step and four roots a chunk.  The deep GP:
    K4 once a step and once in predict, K7 once forward and once backward a
    step.  Matrix-free: K2 once an mBCG iteration for each 128 right-hand
    sides (16 iterations of 1 + 8 a step's loss, 32 of 1 for the state's α,
    16 of a chunk's columns a chunk), K3 once a step, and K12 once an
    iteration of the prior's solves on its 2 dims (the hoist's SLQ, 256;
    each step's quadratic and the state's conditioning solve, 64; none
    stops early) and once a dim for each chunk's conditional mean.  The rest:
    no kernel; N is checked outside K5's, K8's, K10a's and K11's windows."""
    def k9(n1, n2):
        return int(n1 * n2 >= 128 * 128)

    check(not (768 <= n <= 1280 or 6144 <= n <= 8192),
          f"serve_launches derives the counts outside K8's, K10a's, K11's and K5's N windows, got {n}")
    if cfg.matrixfree:  # K2 takes 128 right-hand sides a launch (ops/matvec.MAX_R)
        c, chunks, iters = min(n_pts, 1024), -(-n_pts // 1024), 16 if n <= 32768 else 32
        return {"gibbs_matvec": iters * (executed * -(-(1 + serve.NUM_PROBES) // 128) + 2 + chunks * -(-c // 128)),
                "gibbs_panel_grads": executed, "se_matvec_f64": prior_launches(2, 256, 64 * executed, 64, means=chunks)}
    c, chunks = min(n_pts, 4096), -(-n_pts // 4096)
    m = cfg.num_inducing
    roots = k9(n, m) + k9(m, m) + k9(c, m) + k9(m, m)
    return {"gibbs_exact": {"gibbs_gram": executed * k9(n, n) + chunks * (k9(n, n) + k9(c, c) + k9(c, n))},
            "gibbs_sparse": {"gibbs_gram": executed * (k9(n, m) + k9(m, m)) + chunks * roots},
            "st_nonstationary": {"gibbs_gram": executed * (k9(n, m) + k9(m, m)) + chunks * 2 * roots},
            "deepgp": {"svgp_precompute": executed + 1, "elbo_data_term_fwd": executed,
                       "elbo_data_term_bwd": executed}}.get(cfg.model, {})


def _nonzero(counts: dict) -> dict:
    return {k: v for k, v in counts.items() if v}


def _served(serve, interop, cfg, params: dict, data, x, y, dev, dtype) -> tuple:
    """The serve's ``_predict`` at ``params`` (a JAX model's leaves) on the
    training rows (x, y) in ``dtype``, hindcast at x, in raw units."""
    x, y = x.to(dtype), y.to(dtype)
    _, _, extra = serve._build(cfg.model, x, y, cfg, {})
    model = interop.serve_model_from_jax(cfg.model, params, x.shape[1], dev, dtype, num_layers=cfg.num_layers)
    mean, var = serve._predict(cfg.model, model, x, y, x, cfg, extra=extra)
    return mean.double().cpu().numpy() * data.stdy + data.meany, np.sqrt(var.double().cpu().numpy()) * data.stdy


def _pose_f64(serve, interop, ref, case: str, cfg, fitted: dict, dev) -> float:
    """The serve's ``_predict`` in float64 on ``dev`` at JAX's fitted pose,
    in raw units, against JAX's float64 serve of it: the larger of the mean's
    and σ's largest error over their largest value."""
    data = serve.training_data(cfg, dev, torch.float64)
    got = dict(zip(("mean", "std"), _served(serve, interop, cfg, fitted, data, data.x, data.y, dev, torch.float64)))
    return max(float(np.max(np.abs(got[w] - ref[f"{case}.{w}_f64"])) / np.max(np.abs(ref[f"{case}.{w}_f64"])))
               for w in ("mean", "std"))


def _reorder_spread(serve, interop, cfg, fitted: dict, leaves: tuple, dev) -> dict:
    """The float32 serve's rounding at ``fitted``, sampled on the card: the
    port's float32 ``_predict`` with the training rows and the inducing
    points (``leaves``) in SERVE_REORDERS seeded orders, each against its
    float64 ``_predict`` in the given order, in raw units.  The largest
    error of the mean and of σ over the orders."""
    data = serve.training_data(cfg, dev, torch.float64)
    want = _served(serve, interop, cfg, fitted, data, data.x, data.y, dev, torch.float64)
    rng = np.random.default_rng(SERVE_REORDER_SEED)
    worst = {"mean": 0.0, "std": 0.0}
    for _ in range(SERVE_REORDERS):
        px, pz = rng.permutation(len(data.y)), rng.permutation(len(fitted[leaves[0]]))
        params = {k: v[pz] if k in leaves else v for k, v in fitted.items()}
        rows = torch.as_tensor(px, device=dev)
        got = _served(serve, interop, cfg, params, data, data.x[rows], data.y[rows], dev, torch.float32)
        inv = np.argsort(px)
        for what, g, w in zip(("mean", "std"), got, want):
            worst[what] = max(worst[what], float(np.max(np.abs(g[inv] - w))))
    return worst


def phase_serve_ref(serve, dev):
    """Every family, and the matrix-free path at N = 256 and 2048 (the data
    of tools/pin_jax_gibbs_mf.py), served on the card from the pinned JAX
    serve's init and draws at its tiny budget (SERVE_REF): the step-0 loss
    against JAX's, the last loss, the float64 step-0 loss, the served
    marginals at JAX's fitted pose through a port checkpoint, and each
    run's launches against ``serve_launches``; the matrix-free cases also
    their α and variance-solve relres."""
    from nonstationary_precip_tpu_torch import interop
    from nonstationary_precip_tpu_torch.train.checkpoint import save_pytree

    ref = np.load(SERVE_REF)
    rows, totals = {}, {}
    with tempfile.TemporaryDirectory() as tmp:
        for case in (str(c) for c in ref["cases"]):
            argv, init, fitted, draws = interop.serve_case_from_jax(ref, case, tmp)
            argv += ["--device", "cuda"]
            cfg = serve.config([*argv, "--output", os.path.join(tmp, f"{case}.out.csv")])
            reset_launches()
            out = serve.run(cfg, init=init, draws=draws)
            n = out["n_train"]
            got = check_launches(serve_launches(serve, cfg, n, n, out["executed"]), f"serve_ref {case} fit")
            loss0, jax_losses = float(ref[f"{case}.loss0"]), ref[f"{case}.losses"]
            rel0 = abs(float(out["losses"][0]) - loss0) / abs(loss0)
            rel_last = abs(float(out["losses"][-1]) - float(jax_losses[-1])) / abs(float(jax_losses[-1]))
            tol0 = SERVE_MF_RTOL0 if cfg.matrixfree else SERVE_MVS_RTOL0 if case == "mv_gibbs_sparse" else RTOL_STEP0
            check(out["steps"] == len(jax_losses) and bool(np.isfinite(out["losses"]).all()),
                  f"serve_ref {case}: {out['steps']} finite steps")
            check(rel0 <= tol0, f"serve_ref {case}: step-0 loss vs JAX {rel0:.3g} <= {tol0}")
            if case != "mv_gibbs_sparse":
                check(rel_last <= RTOL_STEP50, f"serve_ref {case}: last loss vs JAX {rel_last:.3g} <= {RTOL_STEP50}")
            row = {"steps": out["steps"], "step0_rel_err": rel0, "last_rel_err": rel_last, "launches": _nonzero(got),
                   "end_to_end_mean_rel": float(np.max(np.abs(out["mean"] - ref[f"{case}.mean"]))
                                                / np.max(np.abs(ref[f"{case}.mean"])))}
            if f"{case}.loss0_f64" in ref.files:
                data64 = serve.training_data(cfg, dev, torch.float64)
                x64, y64 = data64.x, data64.y
                _, loss_fn, extra = serve._build(cfg.model, x64, y64, cfg, {})
                m64 = interop.serve_model_from_jax(cfg.model, init, x64.shape[1], dev, torch.float64,
                                                   num_layers=cfg.num_layers)
                want = float(ref[f"{case}.loss0_f64"])
                row["step0_f64_rel_err"] = abs(float(loss_fn(m64, x64, y64, *extra).detach()) - want) / abs(want)
                check(row["step0_f64_rel_err"] <= SERVE_F64_RTOL,
                      f"serve_ref {case}: float64 step-0 loss vs JAX {row['step0_f64_rel_err']:.3g} <= "
                      f"{SERVE_F64_RTOL}")
            # JAX's fitted pose, as a port checkpoint, served with --checkpoint
            ckpt = os.path.join(tmp, f"{case}.pt")
            save_pytree(ckpt, interop.serve_model_from_jax(cfg.model, fitted, 3 if str(ref[f"{case}.data"]) == "st"
                                                           else 2, dev, num_layers=cfg.num_layers))
            reset_launches()
            pose = serve.run(serve.config([*argv, "--output", "/dev/null", "--checkpoint", ckpt]), draws=draws)
            pose_launches = check_launches(serve_launches(serve, cfg, n, n, 0), f"serve_ref {case} pose")
            row["pose_launches"] = _nonzero(pose_launches)
            spread = {}
            if case in SERVE_REORDERED:
                spread = _reorder_spread(serve, interop, cfg, fitted, SERVE_REORDERED[case], dev)
                row["reorder_max_err"] = spread
            for what in ("mean", "std"):
                want32 = ref[f"{case}.{what}"]
                if f"{case}.{what}_f64" in ref.files:
                    want = ref[f"{case}.{what}_f64"]
                    err, scale = float(np.max(np.abs(pose[what] - want))), float(np.max(np.abs(want)))
                    gap = max(float(np.max(np.abs(want32 - want))), spread.get(what, 0.0))
                    allowed = 2 * gap + SERVE_F64_FLOOR * scale
                else:
                    err = float(np.max(np.abs(pose[what] - want32)))
                    allowed = SERVE_DGP_RTOL * float(np.max(np.abs(want32)))
                check(bool(np.isfinite(pose[what]).all()) and err <= allowed,
                      f"serve_ref {case}: served {what} at JAX's fitted pose {err:.3g} <= {allowed:.3g}")
                row[f"pose_{what}_err"], row[f"pose_{what}_allowed"] = err, allowed
            if f"{case}.mean_f64" in ref.files and not cfg.matrixfree:  # K2 takes float32 only: no float64 there
                row["pose_f64_rel_err"] = _pose_f64(serve, interop, ref, case, cfg, fitted, dev)
                tol = SERVE_POSE_F64_MVS if case == "mv_gibbs_sparse" else SERVE_POSE_F64
                check(row["pose_f64_rel_err"] <= tol,
                      f"serve_ref {case}: float64 serve at JAX's fitted pose {row['pose_f64_rel_err']:.3g} <= {tol}")
            if cfg.matrixfree:
                row.update(alpha_relres=out["alpha_relres"], worst_relres=out["worst_relres"],
                           jax_alpha_relres=float(ref[f"{case}.alpha_relres"]),
                           jax_worst_relres=float(ref[f"{case}.worst_relres"]))
                check(max(out["worst_relres"], pose["worst_relres"]) <= SERVE_RELRES,
                      f"serve_ref {case}: variance solves' relres {out['worst_relres']:.3g}, "
                      f"{pose['worst_relres']:.3g} <= {SERVE_RELRES}")
            for k, v in list(got.items()) + list(pose_launches.items()):
                totals[k] = totals.get(k, 0) + v
            rows[case] = row
    emit("serve_ref", rows=rows, launches=_nonzero(totals))
    return totals


def phase_serve(serve, cli, dev_name: str):
    """``python -m nonstationary_precip_tpu_torch serve`` for every family at
    the bundled data's full size (uib_spatial.csv, 394 sites; the two
    spatio-temporal families on uib_spatio_temporal.csv, 5676 rows) and the
    CLI's default budget, with --save_checkpoint: each run's launches
    against ``serve_launches``, a finite CSV of (N, d + 2), the fit's
    seconds and steps/s (CUDA events), the serve seconds, the back-offs and
    the hindcast RMSE at the training sites; then the CLI's entry
    (``__main__.main(["serve", ...])``) from --checkpoint: predict-only
    launches and the same predictions and CSV, bit for bit.  A family of
    SERVE_DIVERGES must refuse to serve at the defaults (no CSV, no
    checkpoint) and is then served with its flags."""
    rows, totals, cuts = {}, {}, {}
    with tempfile.TemporaryDirectory() as tmp:
        for model in serve.MODELS:
            data = SERVE_ST if model.startswith("st_") else SERVE_SPATIAL
            base = ["--model", model, "--train_csv", *data, "--device", "cuda"]
            out_csv, ckpt = os.path.join(tmp, f"{model}.csv"), os.path.join(tmp, "ckpt", model)
            if model in SERVE_DIVERGES:
                refused = None
                try:
                    serve.run(serve.config([*base, "--output", out_csv, "--save_checkpoint", ckpt]))
                except SystemExit as e:
                    refused = str(e)
                check(refused is not None and "non-finite" in refused and not os.path.exists(ckpt)
                      and not os.path.exists(out_csv),
                      f"serve {model}: refuses to serve a diverged fit at the defaults, no checkpoint left")
                base += list(SERVE_DIVERGES[model])
                cuts[model] = {"flags": list(SERVE_DIVERGES[model]), "reason": "diverges at the defaults (lr 0.002) "
                               "in both packages; refused there, as JAX's CLI refuses"}
            cfg = serve.config([*base, "--output", out_csv, "--save_checkpoint", ckpt])
            reset_launches()
            t0 = time.perf_counter()
            out = serve.run(cfg)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            n, d = out["n_train"], 3 if model.startswith("st_") else 2
            got = check_launches(serve_launches(serve, cfg, n, n, out["executed"]), f"serve {model}")
            field = np.loadtxt(out_csv, delimiter=",", skiprows=1)
            check(field.shape == (n, d + 2) and bool(np.isfinite(field).all()), f"serve {model}: CSV {field.shape}")
            check(bool(np.isfinite(out["losses"]).all()), f"serve {model}: every loss finite")
            check(os.path.isfile(ckpt), f"serve {model}: checkpoint saved")
            restored_csv = os.path.join(tmp, f"{model}.restored.csv")
            reset_launches()
            t0 = time.perf_counter()
            mean, std = cli.main(["serve", *base, "--output", restored_csv, "--checkpoint", ckpt])
            torch.cuda.synchronize()
            restore_wall = time.perf_counter() - t0
            got2 = check_launches(serve_launches(serve, cfg, n, n, 0), f"serve {model} restored")
            same = bool(np.array_equal(mean, out["mean"]) and np.array_equal(std, out["std"]))
            check(same and open(restored_csv).read() == open(out_csv).read(),
                  f"serve {model}: --checkpoint serves the fitted run's predictions bit for bit")
            for k, v in list(got.items()) + list(got2.items()):
                totals[k] = totals.get(k, 0) + v
            rows[model] = {"n": n, "steps": out["steps"], "backoffs": out["backoffs"],
                           "fit_seconds": out["fit_seconds"], "train_seconds": out["train_seconds"],
                           "steps_per_s": out["steps_per_s"], "serve_seconds": out["serve_seconds"],
                           "wall_seconds": wall, "restore_wall_seconds": restore_wall,
                           "hindcast_rmse": out["hindcast_rmse"], "final_loss": float(out["losses"][-1]),
                           "launches": _nonzero(got), "restore_launches": _nonzero(got2)}
    emit("serve", rows=rows, launches=_nonzero(totals),
         budget={"max_iters": cfg.max_iters, "num_epochs": cfg.num_epochs, "cuts": cuts}, device=dev_name)
    return totals


def mode_f64(kind: str, a1, a2, v, block: int = 2048):
    """(K V, |K||V|) in float64 on the card: K the Gibbs Gram of
    a1 = (x1, ℓ1), a2 = (x2, ℓ2), or the RBF Gram of a1 = z1, a2 = z2."""
    from nonstationary_precip_tpu_torch.kernels.gibbs import gibbs_gram_reference
    from nonstationary_precip_tpu_torch.kernels.stationary import _sq_dist

    vd, out, sabs = v.double(), [], []
    for i in range(0, (a1[0] if kind == "gibbs" else a1).shape[0], block):
        if kind == "gibbs":
            k = gibbs_gram_reference(a1[0][i:i + block].double(), a1[1][i:i + block].double(), a2[0].double(),
                                     a2[1].double())
        else:
            k = torch.exp(-0.5 * _sq_dist(a1[i:i + block].double(), a2.double()))
        out.append(k @ vd)
        sabs.append(k.abs() @ vd.abs())
    return torch.cat(out), torch.cat(sabs)


def mode_fns(kind: str, matvec, a1, a2, v):
    """(kernel, plain version), each a function of the mode, on (a1, a2, v)."""
    if kind == "gibbs":
        return (lambda mode: matvec.gibbs_gram_matvec_mma_cuda(*a1, *a2, v, mode),
                lambda mode: matvec.gibbs_gram_matvec_plain(*a1, *a2, v, precision=mode))
    return (lambda mode: matvec.rbf_gram_matvec_mma_cuda(a1, a2, v, mode),
            lambda mode: matvec.rbf_gram_matvec_plain(a1, a2, v, precision=mode))


def mode_errors(kind: str, matvec, a1, a2, v) -> dict:
    """Each mode's kernel and plain version against float64 within
    MODE_BOUND (module note), finite and bitwise repeatable; the 'default'
    kernel against its plain version within MODE_TIGHT of the plain
    version's float64 error."""
    kern, plain = mode_fns(kind, matvec, a1, a2, v)
    ref, sabs = mode_f64(kind, a1, a2, v)
    e_hi = float((plain("highest").double() - ref).abs().max())
    floor = 2 * e_hi + K6_FLOOR * float(ref.abs().max())
    out = {}
    for mode in ("default", "high3"):
        k, again, p = kern(mode), kern(mode), plain(mode)
        torch.cuda.synchronize()
        check(bool(torch.isfinite(k).all()), f"{kind} {mode} finite")
        check(torch.equal(k, again), f"{kind} {mode} bitwise repeatable")
        allowed = MODE_BOUND[mode] * sabs + floor
        rk, rp = ((t.double() - ref).abs() / allowed for t in (k, p))
        check(float(rk.max()) <= 1.0, f"{kind} {mode} kernel vs float64 within its bound: ratio {float(rk.max()):.3g}")
        check(float(rp.max()) <= 1.0, f"{kind} {mode} plain vs float64 within its bound: ratio {float(rp.max()):.3g}")
        out[mode] = {"max_abs_err": float((k - p).abs().max()), "kernel_vs_f64": float((k.double() - ref).abs().max()),
                     "plain_vs_f64": float((p.double() - ref).abs().max()), "bound_ratio_kernel": float(rk.max()),
                     "bound_ratio_plain": float(rp.max()), "largest": float(ref.abs().max())}
        if mode == "default":
            tight = out[mode]["max_abs_err"] / out[mode]["plain_vs_f64"]
            check(tight <= MODE_TIGHT, f"{kind} default kernel vs plain {out[mode]['max_abs_err']:.3g}: "
                  f"{tight:.3g} of the plain version's float64 error <= {MODE_TIGHT}")
            out[mode]["kernel_vs_plain_over_plain_vs_f64"] = tight
    return out


def mode_bias_v(n: int, r: int, gen: torch.Generator) -> torch.Tensor:
    """V = 2^e·(1 + 2⁻⁹ + 7·2⁻²⁰), e uniform in {−2, …, 2}: exact in f32,
    and each mode's bf16 parts drop MODE_BIAS[mode] of it (module note)."""
    return 2.0 ** torch.randint(-2, 3, (n, r), generator=gen).float() * (1 + 2.0**-9 + 7 * 2.0**-20)


def mode_bias(kind: str, matvec, a1, a2, v) -> dict:
    """Each mode's kernel and plain version carry the mode's bias on
    ``v`` = :func:`mode_bias_v`'s: mean((float64 − result) / float64) within
    MODE_BIAS_RTOL of MODE_BIAS[mode] (module note)."""
    kern, plain = mode_fns(kind, matvec, a1, a2, v)
    ref, _ = mode_f64(kind, a1, a2, v)
    out = {}
    for mode in ("default", "high3"):
        got = {who: float(((ref - f(mode).double()) / ref).mean()) for who, f in (("kernel", kern), ("plain", plain))}
        for who, b in got.items():
            check(abs(b - MODE_BIAS[mode]) <= MODE_BIAS_RTOL * MODE_BIAS[mode],
                  f"{kind} {mode} {who} carries the mode's bias: {b:.4g} against {MODE_BIAS[mode]:.4g}")
        out[mode] = {"kernel_bias": got["kernel"], "plain_bias": got["plain"], "predicted": MODE_BIAS[mode]}
    out["highest_plain_bias"] = float(((ref - plain("highest").double()) / ref).mean())
    return out


def mode_bound(matvec, n1: int, n2: int, d: int, r: int, mode: str, dev, elem_ops=None, sfu_ops=None) -> tuple:
    """(least time in ms, what bounds it, its parts) of a mode kernel: the
    FP32 lanes' operations (the element and its rounding), the SFU's (16 a
    clock an SM at the maximum SM clock), the tensor cores' (2R an element
    a pass at the bf16 rate) and the bytes (the payloads and V read, the
    output written)."""
    fp32 = matvec.mode_ops(n1, n2, d, mode, elem_ops)
    mma = matvec.mma_ops(n1, n2, r, mode)
    sfu = sfu_ops if sfu_ops is not None else matvec.matvec_sfu_ops(n1, n2, d)
    nbytes = 4 * ((n1 + n2) * 2 * d + n2 * r + n1 * r)
    clock_hz = sm_clock_mhz() * 1e6
    parts = {"fp32_ms": fp32 / PEAK_F32 * 1e3, "bytes_ms": nbytes / PEAK_BYTES * 1e3,
             "sfu_ms": sfu / (16 * torch.cuda.get_device_properties(dev).multi_processor_count * clock_hz) * 1e3,
             "mma_ms": mma / PEAK_BF16 * 1e3}
    by = max(parts, key=parts.get)
    return parts[by], "bytes" if by == "bytes_ms" else "operations", parts


def gate_step(gibbs_largen, matvec, largen_out, precision: str, dev) -> dict:
    """One loss_matrixfree step of the large-N gate at its trained pose
    (lazy_cg_mll through K2 under ``precision``, its backward through K3),
    and the trained-pose diagnostics through the same K2: the loss, the
    relres and the launches, counted from 0."""
    from nonstationary_precip_tpu_torch.kernels.gibbs import packed_gibbs_cross
    from nonstationary_precip_tpu_torch.ops.lazy_cg import lazy_cg_diagnostics, lazy_cg_mll

    cfg = gibbs_largen.LargeNConfig(n=LARGEN_N, device="cuda")
    n, iters = cfg.n, 16
    x, y = (t.to(dev) for t in gibbs_largen._data(n))
    noise = tuple(torch.as_tensor(a, device=dev) for a in gibbs_largen.probe_draws(cfg.seed, cfg.rank, n))
    p = {k: torch.tensor(v, device=dev, requires_grad=True) for k, v in largen_out["params"].items()}
    kw = dict(block=gibbs_largen.BLOCK, max_iters=iters, tol=1e-6, precond_rank=cfg.rank, cross_fn=packed_gibbs_cross(2),
              matvec_builder=matvec.scaled_packed_gibbs_matvec_builder(2, precision))
    reset_launches()
    aug = torch.cat([x, p["log_ell_pp"]], dim=1)
    val = -lazy_cg_mll(p["raw_s2"], aug, y, noise, torch.exp(p["log_noise"]), panel_vjp=matvec.packed_gibbs_panel_vjp(2),
                       **kw) / n
    val.backward()
    with torch.no_grad():
        diag = lazy_cg_diagnostics(p["raw_s2"], aug, y, noise, torch.exp(p["log_noise"]), **kw)
    name = "gibbs_matvec" if precision in ("highest", "vpu") else f"gibbs_matvec_{precision}"
    launches = check_launches({name: 2 * iters, "gibbs_panel_grads": 1}, f"k2_modes gate step {precision}")
    return {"loss": float(val.detach()), "relres_solve": diag["relres_solve"], "relres_max": diag["relres_max"],
            "broke": diag["broke"], "grad_finite": all(bool(torch.isfinite(t.grad).all()) for t in p.values()),
            "launches": _nonzero(launches)}


def phase_k2_modes(gibbs_largen, matvec, payloads, largen_out, dev):
    """K2's 'default' and 'high3' kernels against their plain versions and
    float64 within MODE_BOUND on the gate's trained payload (16384², R 9)
    and a ragged (1000 × 1300, R 3); 'vpu' is the 'highest' walk (bitwise)
    and refuses R 33; each mode's time against 'highest' (kernel, plain
    version, bound); one gate step under each mode: 'high3' in the gate's
    bands against 'highest', 'default''s relres a reading."""
    gen = torch.Generator().manual_seed(53)
    x, ell = payloads["trained"]
    v = torch.randn(LARGEN_N, 9, generator=gen).to(dev)
    n1, n2, r = MODE_RAGGED
    rag = [t.to(dev) for t in (2 * torch.randn(n1, 2, generator=gen), torch.exp(0.3 * torch.randn(n1, 2, generator=gen)),
                               2 * torch.randn(n2, 2, generator=gen), torch.exp(0.3 * torch.randn(n2, 2, generator=gen)),
                               torch.randn(n2, r, generator=gen))]
    errs = {"trained": mode_errors("gibbs", matvec, (x, ell), (x, ell), v),
            "ragged": mode_errors("gibbs", matvec, tuple(rag[:2]), tuple(rag[2:4]), rag[4])}
    bias = mode_bias("gibbs", matvec, (x, ell), (x, ell), mode_bias_v(LARGEN_N, 9, gen).to(dev))
    vpu = matvec.make_gibbs_matvec(x, ell, x, ell, "vpu")
    check(torch.equal(vpu(v), matvec.gibbs_gram_matvec_cuda(x, ell, x, ell, v)), "'vpu' is the 'highest' walk")
    try:
        vpu(torch.randn(LARGEN_N, 33, device=dev))
        check(False, "'vpu' refuses R = 33")
    except ValueError:
        pass
    times = {"highest": timed_pair(lambda: matvec.gibbs_gram_matvec_cuda(x, ell, x, ell, v),
                                   lambda: matvec.gibbs_gram_matvec_plain(x, ell, x, ell, v), N_TIMED_GRAM)}
    bounds = {}
    for mode in ("default", "high3"):
        times[mode] = timed_pair(lambda m=mode: matvec.gibbs_gram_matvec_mma_cuda(x, ell, x, ell, v, m),
                                 lambda m=mode: matvec.gibbs_gram_matvec_plain(x, ell, x, ell, v, precision=m),
                                 N_TIMED_GRAM)
        bounds[mode] = mode_bound(matvec, LARGEN_N, LARGEN_N, 2, 9, mode, dev)
    steps = {mode: gate_step(gibbs_largen, matvec, largen_out, mode, dev) for mode in ("highest", "high3", "default")}
    hi, h3 = steps["highest"], steps["high3"]
    check(h3["relres_solve"] <= GATE_RELRES and not h3["broke"] and h3["grad_finite"],
          f"'high3' gate step relres {h3['relres_solve']:.3g} <= {GATE_RELRES}")
    rel = abs(h3["loss"] - hi["loss"]) / abs(hi["loss"])
    check(rel <= GATE_LOSS_REL, f"'high3' gate step loss vs 'highest' {rel:.3g} <= {GATE_LOSS_REL}")
    emit("k2_modes", shape=[LARGEN_N, LARGEN_N, 2, 9], ragged=list(MODE_RAGGED), errors=errs, bias=bias, times=times,
         bounds={m: {"bound_ms": b[0], "bound_by": b[1], **b[2]} for m, b in bounds.items()}, gate_steps=steps,
         high3_loss_rel=rel, timed_calls=2 * N_TIMED_GRAM)
    return {mode: {"errs": [e[mode] for e in errs.values()], "t": times[mode], "bound": bounds[mode],
                   "launches": steps[mode]["launches"][f"gibbs_matvec_{mode}"]} for mode in ("default", "high3")}


def phase_k6_modes(exact_largen, matvec, lazy_out, dev):
    """K6's 'default' and 'high3' kernels against their plain versions and
    float64 within MODE_BOUND on the exact gate's trained payload (16384²,
    R 9) and a ragged one; their times against 'highest'; and their path,
    ``make_rbf_matvec(precision=...)``, driving one 16-iteration mBCG solve
    of the gate's trained operator (preconditioned as the gate is, rank-150
    pivoted Cholesky) from 0 launches, its relres a reading."""
    from nonstationary_precip_tpu_torch.ops.bbmm import mbcg, woodbury_precond
    from nonstationary_precip_tpu_torch.ops.lazy_cg import lazy_pivoted_cholesky

    x, y, _ = exact_largen.lazy_data(LARGEN_N)
    model = lazy_out["model"]
    with torch.no_grad():
        ell, s2, noise = model.kernel.base.lengthscale, model.kernel.outputscale, model.likelihood.noise
        x = x.to(dev)
        z = (x / ell).contiguous()
    gen = torch.Generator().manual_seed(59)
    v = torch.randn(LARGEN_N, 9, generator=gen).to(dev)
    n1, n2, r = MODE_RAGGED
    z1, z2, vr = (t.to(dev) for t in (torch.randn(n1, 2, generator=gen), torch.randn(n2, 2, generator=gen),
                                       torch.randn(n2, r, generator=gen)))
    errs = {"trained": mode_errors("rbf", matvec, z, z, v), "ragged": mode_errors("rbf", matvec, z1, z2, vr)}
    bias = mode_bias("rbf", matvec, z, z, mode_bias_v(LARGEN_N, 9, gen).to(dev))
    times = {"highest": timed_pair(lambda: matvec.rbf_gram_matvec_cuda(z, z, v),
                                   lambda: matvec.rbf_gram_matvec_plain(z, z, v), N_TIMED_GRAM)}
    bounds, solves = {}, {}
    for mode in ("default", "high3"):
        times[mode] = timed_pair(lambda m=mode: matvec.rbf_gram_matvec_mma_cuda(z, z, v, m),
                                 lambda m=mode: matvec.rbf_gram_matvec_plain(z, z, v, precision=m), N_TIMED_GRAM)
        bounds[mode] = mode_bound(matvec, LARGEN_N, LARGEN_N, 2, 9, mode, dev, matvec._rbf_elem_ops,
                                  matvec.rbf_matvec_sfu_ops(LARGEN_N, LARGEN_N))
    with torch.no_grad():
        minv = woodbury_precond(lazy_pivoted_cholesky(model.kernel, x, 150), noise)
    for mode in ("highest", "default", "high3"):
        reset_launches()
        with torch.no_grad():
            mv = matvec.make_rbf_matvec(x, x, ell, mode)
            res = mbcg(lambda w: s2 * mv(w) + noise * w, y.to(dev)[:, None], max_iters=16, tol=1e-6, precond=minv)
        name = "rbf_matvec" if mode == "highest" else f"rbf_matvec_{mode}"
        got = check_launches({name: 16}, f"k6_modes solve {mode}")
        solves[mode] = {"relres": float(res.residnorm[0]), "launches": _nonzero(got)}
    emit("k6_modes", shape=[LARGEN_N, LARGEN_N, 2, 9], ragged=list(MODE_RAGGED), errors=errs, bias=bias, times=times,
         bounds={m: {"bound_ms": b[0], "bound_by": b[1], **b[2]} for m, b in bounds.items()}, solves=solves,
         timed_calls=2 * N_TIMED_GRAM)
    return {mode: {"errs": [e[mode] for e in errs.values()], "t": times[mode], "bound": bounds[mode],
                   "launches": solves[mode]["launches"][f"rbf_matvec_{mode}"]} for mode in ("default", "high3")}


def _chunked_case(quickstart, ref, tag: str, n: int, dtype, dev):
    """The port's model, data and prior hoist for a pinned case: the
    quickstart's data and model in ``dtype`` on ``dev``, its own prior
    factors with JAX's pinned SLQ logdets (constants of training), and
    JAX's probe draws."""
    x, y, xs = quickstart.problem(n)
    x, y, xs = (torch.tensor(a, dtype=dtype, device=dev) for a in (x, y, xs))
    model = quickstart.build_model(x)
    rng = np.random.default_rng(quickstart.PROBE_SEED)
    slq = [tuple(torch.tensor(rng.standard_normal(s), dtype=dtype, device=dev)
                 for s in ((32, quickstart.SLQ_PROBES), (n, quickstart.SLQ_PROBES))) for _ in range(2)]
    lpc, _ = model.prior_pre_matrixfree(x, slq, rank=32, block=128, max_iters=96, tol=1e-8)
    pre = (lpc, torch.tensor(ref[f"{tag}.prior_logdet"], dtype=torch.float64, device=dev))
    probes = tuple(torch.tensor(ref[f"{tag}.{u}"], dtype=dtype, device=dev) for u in ("u1", "u2"))
    return x, y, xs, model, pre, probes


def _chunked_loss(rule: str, fused: bool, f64: bool = False):
    """The pinned runs' chunked MAP loss (tools/pin_jax_chunked.py's LOSS;
    in float64 its LOSS_F64: 8 iterations a solve, none stopped early)."""
    from nonstationary_precip_tpu_torch.models.gibbs_gp import make_chunked_map_loss

    budget = dict(tol=1e-14, chunk_iters=4, n_chunks=2, prior_chunk_iters=4, prior_n_chunks=2) if f64 else \
        dict(tol=1e-6, chunk_iters=8, n_chunks=4, prior_chunk_iters=16, prior_n_chunks=8)
    return make_chunked_map_loss(2, block=128, precond_rank=64, precond=rule, precond_shift=1.0, fused_matvec=fused,
                                 **budget)


def phase_chunked_ref(quickstart, dev):
    """The chunked surface against the pinned JAX runs (CHUNKED_REF) at the
    quickstart's N = 384 and at 2048: the step-0 loss and gradients of
    ``make_chunked_map_loss`` under greedy pivots and stride Nyström (and at
    384 keyed Nyström and RPCholesky, JAX's landmarks and Gumbel rows
    passed in), five ``fit_chunked`` steps, the chunked state's α relres and
    its mean-only query, in float32 through K2 and K3; the 384 step-0 cases
    in float64 (the panel paths: K2 takes float32 only) at 1e-10."""
    from nonstationary_precip_tpu_torch.train.optim import fit_chunked

    ref = np.load(CHUNKED_REF)
    rows, launches = {}, {}
    for n in (int(v) for v in ref["ns"]):
        tag = f"n{n}"
        x, y, xs, model, pre, probes = _chunked_case(quickstart, ref, tag, n, torch.float32, dev)
        reset_launches()
        prior_iters = 0  # K12's launches: the prior solves' iterations as each reports them
        for case in ("pivchol", "nystrom", "nystrom_keyed", "pivchol_keyed"):
            if f"{tag}.{case}.loss0" not in ref.files:
                continue
            pkey = (torch.as_tensor(ref[f"{tag}.landmarks"]) if case == "nystrom_keyed" else
                    torch.as_tensor(ref[f"{tag}.gumbel"]) if case == "pivchol_keyed" else None)
            val, g, info = _chunked_loss(case.split("_")[0], True).value_and_grad(model, x, y, pre, probes, pkey=pkey)
            prior_iters += info["iters_prior"]
            want = float(ref[f"{tag}.{case}.loss0"])
            row = {"loss_rel_err": abs(float(val) - want) / abs(want), "relres_max": float(info["relres_max"]),
                   "jax_relres_max": float(ref[f"{tag}.{case}.relres_max"]), "iters": info["iters"]}
            for name, key in (("log_ell", "log_ell_grad"), ("raw_outputscale", "raw_outputscale_grad"),
                              ("likelihood.raw_noise", "raw_noise_grad")):
                row[f"{name}_grad_rel_err"] = _rel(g[name].cpu(), ref[f"{tag}.{case}.{key}"])
            check(row["loss_rel_err"] <= SERVE_MF_RTOL0, f"chunked_ref {tag} {case}: step-0 loss vs JAX "
                  f"{row['loss_rel_err']:.3g} <= {SERVE_MF_RTOL0}")
            worst = max(v for k, v in row.items() if k.endswith("_grad_rel_err"))
            check(worst <= CHUNKED_GRAD_RTOL, f"chunked_ref {tag} {case}: gradients vs JAX {worst:.3g} <= "
                  f"{CHUNKED_GRAD_RTOL}")
            rows[f"{tag}.{case}"] = row
        res = fit_chunked(model, _chunked_loss("pivchol", True), x, y, pre, probe_noise=probes,
                          num_steps=int(ref["steps"]), lr=2e-2)
        jl = ref[f"{tag}.fit_losses"]
        rel0, rel_last = (abs(res.losses[i] - jl[i]) / abs(jl[i]) for i in (0, -1))
        check(res.steps == len(jl) and rel0 <= SERVE_MF_RTOL0 and rel_last <= RTOL_STEP50,
              f"chunked_ref {tag} fit: step 0 {rel0:.3g} <= {SERVE_MF_RTOL0}, last {rel_last:.3g} <= {RTOL_STEP50}")
        cond_info = {}
        state = model.posterior_state_matrixfree(x, y, pre, block=128, tol=1e-8, precond_rank=64, chunk_iters=8,
                                                 n_chunks=16, prior_info=cond_info)
        mean, qinfo = model.posterior_matrixfree_from_state(state, xs, mean_only=True, block=128, chunk_iters=8,
                                                            n_chunks=16, return_info=True)
        prior_iters += int(res.prior_iters.sum()) + sum(cond_info["iters"])
        jm = ref[f"{tag}.query_mean"]
        mean_err = float(np.max(np.abs(mean.double().cpu().numpy() - jm)) / np.max(np.abs(jm)))
        check(mean_err <= RTOL_STEP50 and not bool(qinfo["broke"]),
              f"chunked_ref {tag}: mean-only query vs JAX {mean_err:.3g} <= {RTOL_STEP50}")
        rows[f"{tag}.fit"] = {"losses": res.losses.tolist(), "jax_losses": jl.tolist(), "step0_rel_err": rel0,
                              "last_rel_err": rel_last, "relres": res.relres.tolist(), "iters": res.iters.tolist(),
                              "alpha_relres": float(state[0].alpha_relres), "alpha_iters": state[0].iters,
                              "jax_alpha_relres": float(ref[f"{tag}.alpha_relres"]), "query_mean_rel_err": mean_err}
        got = launch_counts()
        check(got["gibbs_gram"] == 0 and got["gibbs_matvec"] > 0 and got["gibbs_panel_grads"] > 0,
              f"chunked_ref {tag}: K2 and K3 ran, K9 did not: {_nonzero(got)}")
        check(got["se_matvec_f64"] == prior_iters + 2,
              f"chunked_ref {tag}: K12 once a prior mBCG iteration ({prior_iters}) and once a dim for the query's "
              f"mean: {_nonzero(got)}")
        for k, v in got.items():
            launches[k] = launches.get(k, 0) + v
    tag = "n384_f64"
    x, y, _, model, pre, probes = _chunked_case(quickstart, ref, tag, 384, torch.float64, dev)
    for case in ("pivchol", "nystrom"):
        val, g, _ = _chunked_loss(case, False, f64=True).value_and_grad(model, x, y, pre, probes)
        row = {"loss_rel_err": abs(float(val) - float(ref[f"{tag}.{case}.loss0"])) / abs(float(ref[f"{tag}.{case}.loss0"]))}
        for name, key in (("log_ell", "log_ell_grad"), ("raw_outputscale", "raw_outputscale_grad"),
                          ("likelihood.raw_noise", "raw_noise_grad")):
            row[f"{name}_grad_rel_err"] = _rel(g[name].cpu(), ref[f"{tag}.{case}.{key}"])
        worst = max(row.values())
        check(worst <= CHUNKED_F64_RTOL, f"chunked_ref float64 {case}: loss and gradients vs JAX {worst:.3g} <= "
              f"{CHUNKED_F64_RTOL}")
        rows[f"{tag}.{case}"] = row
    emit("chunked_ref", rows=rows, launches=_nonzero(launches))
    return launches


def phase_chunked(serve, quickstart, dev, dev_name: str):
    """(a) The flagship CLI (CHUNKED_FLAGSHIP, --chunked true) at N = 16384
    on a synthetic CSV of the quickstart's function: CHUNKED_STEPS steps and
    a CHUNKED_QUERY-point query with variances; the step-0 chunked loss and
    gradients against the port's monolithic loss_matrixfree with the same
    factor and draws (to rounding); each solve's relres and the landmark
    directions kept of 1024 (F4) as readings; K2's, K3's and K12's
    launches from the iterations each run reports, K9 none.  (b)
    ChunkedMAPLoss without the prior at N = 131072 (Nyström rank 1024,
    shift 10) with the backward whole and in 2 row blocks: the row blocks'
    gradients the whole sweep's bit for bit (K3's row entry takes the whole
    sweep's column splits), every value finite; relres and the kept
    directions as readings; then the same loss with its prior, hoisted as
    serve hoists it: K12 once a prior mBCG iteration, every training solve
    within the relres gate, finite."""
    from nonstationary_precip_tpu_torch.kernels.gibbs import packed_gibbs_cross
    from nonstationary_precip_tpu_torch.models.gibbs_gp import make_chunked_map_loss
    from nonstationary_precip_tpu_torch.ops.lazy_cg import build_precond_factor

    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        rng = np.random.default_rng(61)
        xr = rng.uniform(-3, 3, size=(CHUNKED_N, 2))
        yr = quickstart.truth(xr) + 0.1 * rng.normal(size=CHUNKED_N)
        train = os.path.join(tmp, "train.csv")
        np.savetxt(train, np.column_stack([xr, yr]), delimiter=",", header="x0,x1,y", comments="")
        pts = os.path.join(tmp, "pts.csv")
        np.savetxt(pts, rng.uniform(-3, 3, size=(CHUNKED_QUERY, 2)), delimiter=",", header="x0,x1", comments="")
        argv = ["--model", "gibbs_exact", "--matrixfree", "true", "--chunked", "true", *CHUNKED_FLAGSHIP,
                "--train_csv", train, "--points_csv", pts, "--max_iters", str(CHUNKED_STEPS), "--device", "cuda",
                "--output", os.path.join(tmp, "p.csv")]
        cfg = serve.config(argv)
        reset_launches()
        t0 = time.perf_counter()
        run = serve.run(cfg)
        seconds = time.perf_counter() - t0
        queries = run["query_iters"]
        chunk = min(CHUNKED_QUERY, 1024)
        want = {"gibbs_matvec": int(sum(run["fit_iters"])) * -(-(1 + serve.NUM_PROBES) // 128) + run["alpha_iters"]
                + sum(q * -(-chunk // 128) for q in queries), "gibbs_panel_grads": run["executed"],
                "se_matvec_f64": serve_prior_launches(run)}
        launches = check_launches(want, "chunked flagship CLI")
        check(bool(np.isfinite(run["mean"]).all() and np.isfinite(run["std"]).all()), "chunked CLI served finite")
        # step 0 again, chunked against the monolithic loss with the same factor and draws
        data = serve.training_data(cfg, dev)
        model, loss, extra = serve._build("gibbs_exact", data.x, data.y, cfg, {})
        blk, rank, precond = serve._matrixfree_setup(cfg, CHUNKED_N)
        lpc = model.precond_factor(data.x, rank=rank, precond=precond)
        kept = int((lpc.abs().amax(0) > 0).sum())
        val, g, info = loss.value_and_grad(model, data.x, data.y, extra[0], extra[1])
        mono = model.loss_matrixfree(data.x, data.y, extra[1], extra[0], block=blk, precond_lpc=lpc,
                                     precond_shift=cfg.precond_shift, max_iters=cfg.chunk_iters * cfg.n_chunks,
                                     prior_max_iters=8 * 8)
        mono.backward()
        mono_rel = abs(float(val) - float(mono.detach())) / abs(float(mono.detach()))
        grad_rel = _rel(g["log_ell"].cpu(), model.log_ell.grad.cpu())
        check(mono_rel <= 1e-5 and grad_rel <= 1e-3,
              f"chunked step 0 vs loss_matrixfree: loss {mono_rel:.3g} <= 1e-5, field gradient {grad_rel:.3g} <= 1e-3")
        out["flagship"] = {"n": CHUNKED_N, "steps": run["steps"], "losses": run["losses"].tolist(),
                           "fit_relres": run["fit_relres"].tolist(), "fit_iters": run["fit_iters"].tolist(),
                           "alpha_relres": run["alpha_relres"], "alpha_iters": run["alpha_iters"],
                           "worst_query_relres": run["worst_relres"], "query_iters": queries,
                           "hoist_seconds": run["hoist_seconds"], "hoist_iters": run["hoist_iters"],
                           "hoist_relres": run["hoist_relres"], "fit_prior_iters": run["fit_prior_iters"].tolist(),
                           "fit_prior_relres": run["fit_prior_relres"].tolist(), "prior_iters": run["prior_iters"],
                           "kept_directions": kept, "rank": rank, "step0_vs_monolithic_rel": mono_rel,
                           "step0_field_grad_rel": grad_rel, "step0_relres_max": float(info["relres_max"]),
                           "fit_seconds": run["fit_seconds"], "serve_seconds": run["serve_seconds"],
                           "wall_seconds": seconds, "launches": _nonzero(launches)}
    # (b) the prior-free loss at N = 131072, the backward whole and in 2 row blocks
    rng = np.random.default_rng(67)
    xb = torch.tensor(rng.uniform(-3, 3, size=(CHUNKED_BIG, 2)), dtype=torch.float32, device=dev)
    yb = torch.tensor(quickstart.truth(xb.double().cpu().numpy()) + 0.1 * rng.normal(size=CHUNKED_BIG),
                      dtype=torch.float32, device=dev)
    model = quickstart.build_model(xb)
    probes = (torch.tensor(rng.standard_normal((1024, 8)), dtype=torch.float32, device=dev),
              torch.tensor(rng.standard_normal((CHUNKED_BIG, 8)), dtype=torch.float32, device=dev))
    big = {}
    for rows in (1, 2):
        loss = make_chunked_map_loss(2, include_prior=False, bwd_row_chunks=rows)
        reset_launches()
        t0 = time.perf_counter()
        val, g, info = loss.value_and_grad(model, xb, yb, None, probes)
        torch.cuda.synchronize()
        got = launch_counts()
        check(got["gibbs_gram"] == 0 and got["gibbs_matvec"] == info["iters"] and got["gibbs_panel_grads"] == rows,
              f"chunked N = {CHUNKED_BIG}, {rows} row block(s): K2 once an iteration, K3 once a block: {_nonzero(got)}")
        check(bool(torch.isfinite(val)) and all(bool(torch.isfinite(t).all()) for t in g.values()),
              f"chunked N = {CHUNKED_BIG}: finite loss and gradients")
        big[rows] = (val, g, info, time.perf_counter() - t0, _nonzero(got))
    # the same loss with its prior, hoisted as serve hoists it (rank 50, 16
    # SLQ probes, 256 iterations at tol 1e-10): K12 once a prior mBCG
    # iteration, the training solves within the gate
    slq = [tuple(torch.tensor(rng.standard_normal(shape), dtype=torch.float32, device=dev)
                 for shape in ((serve.PRIOR_RANK, serve.PRIOR_PROBES), (CHUNKED_BIG, serve.PRIOR_PROBES)))
           for _ in range(2)]
    reset_launches()
    t0 = time.perf_counter()
    hoist = {}
    pre = model.prior_pre_matrixfree(xb, slq, rank=serve.PRIOR_RANK, block=2048, info=hoist)
    torch.cuda.synchronize()
    hoist_s, t0 = time.perf_counter() - t0, time.perf_counter()
    vp, gp, ip = make_chunked_map_loss(2).value_and_grad(model, xb, yb, pre, probes)
    torch.cuda.synchronize()
    loss_s, got = time.perf_counter() - t0, launch_counts()
    hoist_iters = [h["iters"] for h in hoist["dims"]]
    check(got == {**{k: 0 for k in got}, "gibbs_matvec": ip["iters"], "gibbs_panel_grads": 1,
                  "se_matvec_f64": sum(hoist_iters) + ip["iters_prior"]},
          f"chunked N = {CHUNKED_BIG} with its prior: K2 once an iteration, K3 once, K12 once a prior iteration "
          f"({sum(hoist_iters)} + {ip['iters_prior']}): {_nonzero(got)}")
    check(bool(torch.isfinite(vp)) and all(bool(torch.isfinite(t).all()) for t in gp.values())
          and bool(torch.isfinite(pre[1]).all()), f"chunked N = {CHUNKED_BIG} with its prior: finite")
    check(float(ip["relres_max"]) <= SERVE_RELRES,
          f"chunked N = {CHUNKED_BIG} with its prior: training solves' relres {float(ip['relres_max']):.3g} <= "
          f"{SERVE_RELRES}")
    out["with_prior"] = {"n": CHUNKED_BIG, "loss": float(vp), "relres_mll": ip["relres_mll"].tolist(),
                         "relres_prior": ip["relres_prior"].tolist(), "iters": ip["iters"],
                         "iters_prior": ip["iters_prior"], "hoist_iters": hoist_iters,
                         "hoist_relres": [float(h["relres"].max()) for h in hoist["dims"]],
                         "hoist_converged": [int(h["converged"].max()) for h in hoist["dims"]],
                         "prior_logdet": pre[1].tolist(), "seconds": {"hoist": hoist_s, "loss": loss_s},
                         "launches": _nonzero(got)}
    (v1, g1, i1, s1, l1), (v2, g2, _, s2, l2) = big[1], big[2]
    grad_rel = max(_rel(g2[k].cpu(), g1[k].cpu()) for k in ("log_ell", "raw_outputscale", "likelihood.raw_noise"))
    check(float(v1) == float(v2) and all(torch.equal(g1[k], g2[k]) for k in g1),
          f"row-block gradients bit for bit the whole sweep's (relative difference {grad_rel:.3g})")
    aug = torch.cat([xb, model.log_ell.detach()], dim=1)
    lpc = build_precond_factor("nystrom", model.raw_outputscale.detach(), aug, 1024, packed_gibbs_cross(2))
    out["prior_free"] = {"n": CHUNKED_BIG, "loss": float(v1), "relres_mll": i1["relres_mll"].tolist(),
                         "iters": i1["iters"], "kept_directions": int((lpc.abs().amax(0) > 0).sum()),
                         "row_block_grad_rel": grad_rel, "seconds": {"rows1": s1, "rows2": s2},
                         "launches": {"rows1": l1, "rows2": l2}}
    emit("chunked", device=dev_name, **out)
    return {k: out["flagship"]["launches"].get(k, 0) + l1.get(k, 0) + l2.get(k, 0)
            + out["with_prior"]["launches"].get(k, 0) for k in ("gibbs_matvec", "gibbs_panel_grads", "se_matvec_f64")}


def serve_prior_launches(run: dict) -> int:
    """K12's launches in a matrix-free serve from what its solves report:
    the hoist's SLQ, each step's prior quadratics (the chunked fit's), the
    state's conditioning solves, and a conditional mean a dim for each
    query chunk."""
    return (sum(run["hoist_iters"]) + int(sum(run.get("fit_prior_iters", ()))) + sum(run["prior_iters"])
            + len(run["prior_iters"]) * len(run["query_iters"]))


def baselines_launches(cfg, n: int, n_test: int, steps: int, predictives: int) -> dict:
    """What the driver launches, from the code: the exact Gibbs loss takes
    K8 once a step at 768 ≤ N ≤ 1280 and otherwise its noisy Gram through
    K9 where N² ≥ 128²; the sparse loss K9 for K_xz and K_zz (each where
    N₁·N₂ ≥ 128²); each predictive (one per test_interval record, one at the
    end) K9 for K_xx, K_ss and K_sx, K10a for its factor and K11 for
    L⁻¹K_xs in their 768 ≤ N ≤ 1280 windows (K11 within its element
    budget), or, sparse, K9 for both roots' K_xz and K_zz.  The SE-ARD
    baseline launches nothing."""
    from nonstationary_precip_tpu_torch.ops import trsm

    def k9(n1, n2):
        return int(n1 * n2 >= 128 * 128)

    check(not 6144 <= n <= 8192, f"baselines_launches derives the counts outside K5's window, got {n}")
    if cfg.model != "DiagonalGibbs":
        return {}
    if cfg.inference == "sparse":
        m = cfg.num_inducing
        return {"gibbs_gram": steps * (k9(n, m) + k9(m, m)) + predictives * (k9(n, m) + k9(n_test, m) + 2 * k9(m, m))}
    dense = 768 <= n <= 1280
    pred_k9 = k9(n, n) + k9(n_test, n_test) + k9(n_test, n)
    return {"gibbs_chol_solve_fused": steps * dense,
            "gibbs_gram": steps * (not dense) * k9(n, n) + predictives * pred_k9,
            "blocked_cholesky": predictives * dense,
            "blocked_trsm": predictives * (dense and n * n + 2 * n * n_test <= trsm.MAX_TOTAL_ELEMS)}


def _run_driver(pb, argv: list, z=None) -> tuple:
    """The driver on ``argv`` on the card, quietly, its launches counted from
    0: (run's output, train.jsonl's records, the launch counts).  With
    ``z``, its k-means returns these centres (JAX's, carried across)."""
    cfg = pb.default_config().parse_args([*argv, "--device", "cuda"])
    kmeans = pb.kmeans_inducing_points
    if z is not None:
        pb.kmeans_inducing_points = lambda first, x, m: torch.as_tensor(z, dtype=x.dtype, device=x.device)
    try:
        reset_launches()
        with contextlib.redirect_stdout(io.StringIO()) as printed:
            out = pb.run(cfg)
        torch.cuda.synchronize()
        got = launch_counts()
    finally:
        pb.kmeans_inducing_points = kmeans
    out["printed"] = printed.getvalue()
    recs = [json.loads(line) for line in (out["logdir"] / "train.jsonl").read_text().splitlines()]
    n, n_test = out["tensors"][0].shape[0], out["tensors"][2].shape[0]
    predictives = sum("rmse" in r for r in recs) + 1
    want = baselines_launches(cfg, n, n_test, out["steps"], predictives)
    expect = {k: want.get(k, 0) for k in got}
    check(got == expect, f"driver {argv}: launches {got} == {expect}")
    return out, recs, _nonzero(got)


def phase_baselines_ref(pb):
    """The driver, exact and sparse, at the pinned JAX runs' argv (20 steps,
    M = 20, the sparse run from JAX's k-means centres): the step-0 loss, the
    JSONL records and the final metrics against JAX's, the run directory's
    entries (without tb/, which needs tensorboardX) and the launches."""
    ref = np.load(BASELINES_REF)
    keys = list(ref["record_keys"])
    rows, totals = {}, {}
    with tempfile.TemporaryDirectory() as tmp:
        for case in ("exact", "sparse"):
            z = ref[f"{case}.z"] if f"{case}.z" in ref.files else None
            out, recs, got = _run_driver(pb, [*ref[f"{case}.argv"], "--logdir", tmp, "--name", case], z)
            losses, jrecs = ref[f"{case}.losses"], [dict(zip(keys, r)) for r in ref[f"{case}.records"]]
            check(out["steps"] == len(losses) and bool(np.isfinite(out["losses"]).all()),
                  f"{case}: {out['steps']} steps, finite losses")
            rel0 = float(abs(out["losses"][0] - losses[0]) / abs(losses[0]))
            check(rel0 <= RTOL_STEP0, f"baselines_ref {case}: step-0 loss vs JAX {rel0:.3g} <= {RTOL_STEP0}")
            check([r["step"] for r in recs] == [int(r["step"]) for r in jrecs], f"{case}: the records' steps")
            gaps = {k: [] for k in ("objective", *BASELINES_METRIC_RTOL)}
            for got_r, want_r in zip(recs, jrecs):
                gap = abs(got_r["objective"] - want_r["objective"])
                check(gap <= BASELINES_OBJECTIVE_TOL * max(1.0, abs(want_r["objective"])),
                      f"baselines_ref {case} step {got_r['step']}: objective {got_r['objective']} vs JAX's "
                      f"{want_r['objective']}")
                gaps["objective"].append(gap)
                for k, rtol in BASELINES_METRIC_RTOL.items():
                    rel = abs(got_r[k] - want_r[k]) / abs(want_r[k])
                    check(rel <= rtol, f"baselines_ref {case} step {got_r['step']}: {k} {got_r[k]} vs JAX's "
                                       f"{want_r[k]} ({rel:.3g} > {rtol})")
                    gaps[k].append(rel)
            files = {p.name for p in out["logdir"].iterdir()} - {"tb"}
            check(files == set(ref[f"{case}.files"]) - {"tb"}, f"{case}: the run directory {sorted(files)}")
            for k, v in got.items():
                totals[k] = totals.get(k, 0) + v
            rows[case] = {"step0_rel_err": rel0, "gaps": gaps, "rmse": out["rmse"], "nlpd": out["nlpd"],
                          "jax_rmse": float(ref[f"{case}.rmse"]), "jax_nlpd": float(ref[f"{case}.nlpd"]),
                          "launches": got}
    emit("baselines_ref", rows=rows, launches=totals)
    return totals


def phase_baselines(pb, dev_name: str):
    """The driver at its defaults (uib_spatial.csv, 316 training rows, 2000
    iterations, log 50, test 200, threshold 1e-6), exact and sparse (M =
    250): finite RMSE and NLPD, the JSONL and the best/ and final/
    checkpoints written, the launches; seconds and steps/s from the fit's
    CUDA events; then the driver resumed from final/ with --max_iters 0
    serves the trained model's predictive bit for bit."""
    rows, totals = {}, {}
    with tempfile.TemporaryDirectory() as tmp:
        for case in ("exact", "sparse"):
            t0 = time.perf_counter()
            out, recs, got = _run_driver(pb, ["--inference", case, "--logdir", tmp, "--name", case])
            wall = time.perf_counter() - t0
            check(np.isfinite(out["rmse"]) and np.isfinite(out["nlpd"]), f"baselines {case}: RMSE and NLPD finite")
            run = out["logdir"]
            for tag in ("best", "final", "init_model"):
                check((run / tag / "model").is_file() and (tag == "init_model" or (run / tag / "meta.json").is_file()),
                      f"baselines {case}: {tag}/ written")
            check(len(recs) == -(-out["steps"] // 50) and all("objective" in r for r in recs),
                  f"baselines {case}: one record every 50 steps")
            final = str(run / "final")
            again, _, got2 = _run_driver(pb, ["--inference", case, "--logdir", tmp, "--name", f"{case}_resumed",
                                              "--resume", final, "--max_iters", "0"])
            stdy = out["stdy"]
            p1 = pb.metrics(out["model"], out["tensors"], stdy)[0]
            p2 = pb.metrics(again["model"], again["tensors"], stdy)[0]
            check(torch.equal(p1.mean, p2.mean) and torch.equal(p1.cov, p2.cov)
                  and (again["rmse"], again["nlpd"]) == (out["rmse"], out["nlpd"]),
                  f"baselines {case}: --resume from final/ serves the trained predictive bit for bit")
            for k, v in list(got.items()) + list(got2.items()):
                totals[k] = totals.get(k, 0) + v
            rows[case] = {"steps": out["steps"], "rmse": out["rmse"], "nlpd": out["nlpd"],
                          "final_loss": float(out["losses"][-1]), "train_seconds": out["seconds"],
                          "steps_per_s": (out["steps"] - 1) / out["seconds"], "wall_seconds": wall,
                          "launches": got, "resume_launches": got2}
    emit("baselines", rows=rows, launches=totals, device=dev_name)
    return totals


def phase_baselines_dense(pb, gibbs_fused, dev, dev_name: str):
    """The driver on a 1280-row CSV (BASELINES_DENSE_*: N_train 1025, 255
    test rows) at its defaults: K8 once a step, each predictive K9 three
    times, K10a and K11 once; finite metrics; then K8 at the trained pose
    against its plain version and float64 (``k8_errors``, phase k8's
    criteria)."""
    rng = np.random.default_rng(BASELINES_DENSE_SEED)
    x = rng.uniform(-2.0, 2.0, size=(BASELINES_DENSE_ROWS, 2))
    y = np.sin(x[:, 0]) + 0.1 * rng.normal(size=BASELINES_DENSE_ROWS)
    with tempfile.TemporaryDirectory() as tmp:
        csv = os.path.join(tmp, "dense.csv")
        np.savetxt(csv, np.c_[x, y], delimiter=",", header="x0,x1,y", comments="")
        t0 = time.perf_counter()
        out, recs, got = _run_driver(pb, ["--data", csv, "--train_percent", "80", "--logdir", tmp, "--name", "dense"])
        wall = time.perf_counter() - t0
    x_tr, y_tr = out["tensors"][0], out["tensors"][1]
    check(x_tr.shape[0] == BASELINES_DENSE_TRAIN and got.get("gibbs_chol_solve_fused") == out["steps"],
          f"baselines_dense: N_train {x_tr.shape[0]} == {BASELINES_DENSE_TRAIN}, K8 once a step")
    check(np.isfinite(out["rmse"]) and np.isfinite(out["nlpd"]), "baselines_dense: RMSE and NLPD finite")
    m = out["model"]
    with torch.no_grad():
        errs = k8_errors(gibbs_fused, "baselines_dense_trained", x_tr, torch.exp(m.log_ell).contiguous(), y_tr,
                         m.outputscale.detach(), m.likelihood.noise.detach())
    emit("baselines_dense", steps=out["steps"], launches=got, rmse=out["rmse"], nlpd=out["nlpd"],
         train_seconds=out["seconds"], steps_per_s=(out["steps"] - 1) / out["seconds"], wall_seconds=wall,
         k8_trained=errs, device=dev_name)
    return got, errs


@contextlib.contextmanager
def k4_plain(svgp_precompute):
    """K4's plain version in the kernel's place, for a float64 reference on
    the card (the kernel takes float32); nothing is counted."""
    forward = svgp_precompute._forward
    svgp_precompute._forward = svgp_precompute.svgp_precompute_plain
    try:
        yield
    finally:
        svgp_precompute._forward = forward


def phase_full_cov(deepgp_spatial, svgp_precompute, dev, dev_name: str):
    """``DeepGP.loss(full_cov=True)`` at the dgp shapes (split 0 of the
    experiment: B 315, S 3, M 250, two hidden layers of width 2) for
    FULL_COV_STEPS Adam steps: K4 once a step, K7 never; then the loss and
    every gradient at the trained pose against the same computation in
    float64 on the card with the same ε (K4's plain version there)."""
    import copy

    from nonstationary_precip_tpu_torch.data.dataprep import load_csv
    from nonstationary_precip_tpu_torch.utils.config import DATASET_DIR

    cfg = deepgp_spatial.default_config().parse_args(["--device", "cuda"])
    data = load_csv(DATASET_DIR / "uib_spatial.csv")
    model, (x, y, _, _), _, eps, _ = deepgp_spatial.prep_split(data, 0, cfg, dev=dev)
    n = x.shape[0]
    check(tuple(eps[0].shape[1:]) == (3, 2, 315) and model.layers[0].z.shape[-2] == 250,
          f"full_cov at the dgp shapes: ε {tuple(eps[0].shape)}")
    opt = torch.optim.Adam([p for p in model.parameters() if p.requires_grad], lr=cfg.lr)
    reset_launches()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    losses = []
    for t in range(FULL_COV_STEPS):
        if t == 1:
            start.record()
        opt.zero_grad(set_to_none=True)
        loss = model.loss(x, y, n, [e[t] for e in eps], full_cov=True)
        loss.backward()
        opt.step()
        losses.append(loss.detach())
    stop.record()
    stop.synchronize()
    got = check_launches({"svgp_precompute": FULL_COV_STEPS}, "full_cov")
    losses = torch.stack(losses).cpu().numpy()
    check(bool(np.isfinite(losses).all()), f"full_cov losses finite: {losses.tolist()}")

    def value_and_grad(dtype):
        m = copy.deepcopy(model).to(dtype)
        m.zero_grad(set_to_none=True)
        loss = m.loss(x.to(dtype), y.to(dtype), n, [e[FULL_COV_STEPS].to(dtype) for e in eps], full_cov=True)
        loss.backward()
        return float(loss.detach()), torch.cat([p.grad.flatten().double() for p in m.parameters()
                                                if p.grad is not None])

    reset_launches()
    l32, g32 = value_and_grad(torch.float32)
    with k4_plain(svgp_precompute):
        l64, g64 = value_and_grad(torch.float64)
    rel = abs(l32 - l64) / abs(l64)
    grel = float((g32 - g64).norm() / g64.norm())
    cos = float(g32 @ g64 / (g32.norm() * g64.norm()))
    check(rel <= FULL_COV_LOSS_RTOL, f"full_cov loss vs float64 {rel:.3g} <= {FULL_COV_LOSS_RTOL}")
    check(grel <= FULL_COV_GRAD_REL and cos >= FULL_COV_GRAD_COS,
          f"full_cov gradient vs float64: relative L2 {grel:.3g} <= {FULL_COV_GRAD_REL}, cosine {cos:.6f}")
    emit("full_cov", steps=FULL_COV_STEPS, launches=_nonzero(got), losses=losses.tolist(),
         ms_per_step=start.elapsed_time(stop) / (FULL_COV_STEPS - 1), loss_rel_err_f64=rel, grad_rel_l2_f64=grel,
         grad_cosine_f64=cos, device=dev_name)
    return got["svgp_precompute"]


def phase_dense_cg(quickstart_cg, dev, dev_name: str):
    """``ExactGP.mll(solver='cg')`` and ``predictive(solver='cg')`` on the
    dense Gram at quickstart_cg_largen's N = 1600 (its data, rank-15
    pivoted-Cholesky preconditioner, 16 probes, 200 iterations; at init):
    the CG MLL within 3σ of the Cholesky MLL, σ the estimator's spread
    over DENSE_CG_SETS independent probe sets (float64); float32 against
    float64 on the same probes, the value within σ and the gradient within
    DENSE_CG_GRAD_SPREADS of the sets' gradient spreads; the CG predictive
    mean within 1e-2 of Cholesky's (the quickstart's assert); no kernel (N
    is outside K10a's and K5's windows; CG's products are cuBLAS's).  Times
    (CUDA events) of the CG MLL with its backward and of the Cholesky MLL."""
    import copy

    from nonstationary_precip_tpu_torch.kernels.base import Scale
    from nonstationary_precip_tpu_torch.kernels.stationary import RBF
    from nonstationary_precip_tpu_torch.models.exact_gp import ExactGP

    x_tr, y_tr, x_te, y_te = (torch.tensor(a, dtype=torch.float32, device=dev) for a in quickstart_cg.problem(2000))
    n = x_tr.shape[0]
    model = ExactGP.create(Scale.create(RBF.create(2, device=dev), device=dev), noise=0.1, device=dev)
    kw = dict(solver="cg", max_iters=200, precond_rank=quickstart_cg.RANK)
    probes = quickstart_cg.probe_noise(n, 16, dev, np.random.default_rng(quickstart_cg.PROBE_SEED))

    def value_and_grad(m, xs, ys, noise):
        m.zero_grad()
        v = m.mll(xs, ys, probe_noise=noise, **kw)
        v.backward()
        return float(v.detach()), torch.cat([p.grad.flatten().double() for p in m.parameters()])

    reset_launches()
    m64 = copy.deepcopy(model).double()
    x64, y64 = x_tr.double(), y_tr.double()
    sets = [value_and_grad(m64, x64, y64, tuple(u.double() for u in quickstart_cg.probe_noise(
        n, 16, dev, np.random.default_rng(1000 + k)))) for k in range(DENSE_CG_SETS)]
    sigma = float(np.std([v for v, _ in sets], ddof=1))
    gsigma = float(torch.stack([g for _, g in sets]).std(dim=0).norm())
    v32, g32 = value_and_grad(model, x_tr, y_tr, probes)
    v64, g64 = value_and_grad(m64, x64, y64, tuple(u.double() for u in probes))
    with torch.no_grad():
        chol = float(model.mll(x_tr, y_tr))
        pred = model.predictive(x_tr, y_tr, x_te, solver="cg", max_iters=300, precond_rank=quickstart_cg.RANK)
        pred_chol = model.predictive(x_tr, y_tr, x_te)
        dmean = float((pred.mean - pred_chol.mean).abs().max())
    got = check_launches({}, "dense_cg")
    check(abs(v32 - chol) <= 3 * sigma, f"dense_cg: CG MLL {v32:.5f} within 3σ ({sigma:.3g}) of Cholesky's {chol:.5f}")
    check(abs(v32 - v64) <= sigma, f"dense_cg: float32 value {v32:.6f} within σ {sigma:.3g} of float64's {v64:.6f}")
    gap = float((g32 - g64).norm())
    check(gap <= DENSE_CG_GRAD_SPREADS * gsigma,
          f"dense_cg: float32 gradient {gap:.3g} from float64's, within {DENSE_CG_GRAD_SPREADS} × {gsigma:.3g}")
    check(dmean < 1e-2, f"dense_cg: CG predictive mean within 1e-2 of Cholesky's: {dmean:.3g}")
    cg_ms = statistics.median(block_times_ms(lambda: value_and_grad(model, x_tr, y_tr, probes), 10))
    chol_ms = statistics.median(block_times_ms(lambda: model.mll(x_tr, y_tr), 10))
    emit("dense_cg", n=n, mll_cg=v32, mll_cg_f64=v64, mll_chol=chol, slq_sigma=sigma, grad_gap_f64=gap,
         grad_spread=gsigma, grad_rel_l2_f64=gap / float(g64.norm()), pred_mean_max_abs_diff=dmean,
         cg_value_and_grad_ms=cg_ms, chol_mll_ms=chol_ms, launches=_nonzero(got), device=dev_name)


def quickstart_launches(name: str, out, quickstart) -> dict:
    """Each ported quickstart's launches at its defaults, from the code:
    gibbs_spatial's loss K9 once a step (its noisy Gram, N = 315) and its
    predictive K9 for K_xx and K_sx (K_ss, 79², is under K9's 128² gate);
    deepgp's K4 once a step and once in predict, K7 once forward and once
    backward a step; lazy_largen's K6 once an mBCG iteration for each 128
    right-hand sides: 100 iterations of 1 + 8 in each of the 25 steps' and
    the parity's losses, 1000 of 1 + 64 in the posterior; exact_gp and
    cg_largen (N = 1600, outside K10a's window) none."""
    if name == "gibbs_spatial":
        return {"gibbs_gram": len(out["losses"]) + 2}
    if name == "deepgp":
        return {"svgp_precompute": out["steps"] + 1, "elbo_data_term_fwd": out["steps"],
                "elbo_data_term_bwd": out["steps"]}
    if name == "lazy_largen":
        return {"rbf_matvec": 26 * quickstart.ITERS * -(-(1 + quickstart.NUM_PROBES) // 128) + 1000 * -(-65 // 128)}
    return {}


def phase_quickstarts(dev_name: str):
    """The five ported quickstarts at their defaults on the card, each with
    its own asserts and its "ok", their launches counted
    (``quickstart_launches``) and their seconds."""
    import importlib

    rows, totals = {}, {}
    for name in QUICKSTARTS:
        quickstart = importlib.import_module(f"nonstationary_precip_tpu_torch.examples.quickstart_{name}")
        reset_launches()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()) as printed:
            out = quickstart.main(dev="cuda")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        lines = printed.getvalue().splitlines()
        check(lines[-1:] == ["ok"], f"quickstart {name} ends with ok: {lines[-3:]}")
        got = check_launches(quickstart_launches(name, out, quickstart), f"quickstart {name}")
        for k, v in got.items():
            totals[k] = totals.get(k, 0) + v
        rows[name] = {"seconds": wall, "launches": _nonzero(got), "printed": lines[-4:-1]}
    emit("quickstarts", rows=rows, launches=_nonzero(totals), device=dev_name)
    return totals


# ---------------------------------------------------------------------------
# parallel/ at world 1 on NCCL
# ---------------------------------------------------------------------------

PAR_DGP_STEPS = 3  # Adam steps of the data-parallel DSVI check at bench.py's shapes
PAR_DGP = (315, 250, 3)  # B, M, S (bench.py:22-26; 2 hidden layers of width 2)
PAR_FIT_STEPS = 50  # fit_splits(mesh=) on WORLD_SPLITS splits of the Gibbs slice
PAR_CHOL_N, PAR_CHOL2D_N, PAR_BLOCK = 8192, 4096, 256
#: F-P8's input (``fp8_input``): N and the jitters at which the product form
#: JAX's panel takes broke γ_{N+1}|L||Lᵀ| 481 and 2775 times over on the
#: CPU (tests/test_torch_parallel.py), where potrf factors both
PAR_FP8_N, PAR_FP8_JITTERS = 1024, (1e-4, 2e-5)
PAR_CG_ITERS, PAR_CG_RANK = 16, 150  # the large-N gate's budget and rank
PAR_DEFAULT_N = 4096  # the default (materialised row block) path, counted for no kernel
PAR_NYSTROM = (1024, 10.0)  # rank, shift: serve --chunked's flagship factor
PAR_QUERY = 512
#: the float32 floor of ``_gap``: PAR_SPARSE_F32_FLOOR of the result's scale
#: beside the multiple of one device's own float32 gap to float64
PAR_SPARSE_F32_FLOOR = 1e-5
#: the sparse Gibbs bound's float64 run on the group against one device's
#: float64, relative to each leaf's largest entry (the gradients' bounds are
#: tests/test_torch_sparse_gp.py's float64 ones at this size, where z's
#: gradient loses ~9 digits to M = 250's conditioning)
PAR_SPARSE_F64 = {"loss": 1e-10, "z": 1e-4, "log_ell_z": 1e-5}
#: the sharded CG paths' float64 run against one device's float64, relative
#: to each leaf's largest entry: tests/test_torch_sharded_cg.py's bound for
#: the port at P ranks against itself at P = 1, where the only difference is
#: the BLAS blocking of an (N/P, N) row block against the whole
PAR_CG_F64 = 1e-9
#: the demos' launches: the mv_gibbs demo's two 900² factors take 5 + 1
#: tries of safe_cholesky's ladder (its latent prior's Gram is indefinite
#: in float32 until a jitter of 1e-3), the matrix-normal one's two (U, in
#: the draw and in the log-density) 1 + 1; the log-density's (900, 2) solve
#: through K11
DEMO_LAUNCHES = {"mv_gibbs_demo": {"blocked_cholesky": 6},
                 "matrix_normal_demo": {"blocked_cholesky": 2, "blocked_trsm": 1}}
K2_ROW_BLOCKS = 4  # the per-rank work of a 4-card run


@contextlib.contextmanager
def world1(dev):
    """A process group of one rank, started from a ``FileStore`` in a
    temporary directory (no network): NCCL on the card.  Destroyed on exit."""
    import torch.distributed as dist

    from nonstationary_precip_tpu_torch.parallel import init_world, make_mesh

    with tempfile.TemporaryDirectory() as d:
        init_world(1, 0, os.path.join(d, "store"), device=dev.type)
        try:
            yield make_mesh()
        finally:
            dist.destroy_process_group()


def fp8_input(jitter: float) -> torch.Tensor:
    """F-P8's ill-conditioned input, float32 on the CPU: the H prior's RBF
    row covariance (ℓ 0.5, ``priors/matrix_normal.latent_rbf_row_cov``) on
    a 32 × 32 grid of [−2, 2]² (N = PAR_FP8_N) plus ``jitter``·I."""
    from nonstationary_precip_tpu_torch.priors.matrix_normal import latent_rbf_row_cov

    g = np.linspace(-2.0, 2.0, 32)
    gx, gy = np.meshgrid(g, g)
    u = latent_rbf_row_cov(torch.tensor(np.stack([gx.ravel(), gy.ravel()], 1), dtype=torch.float32), [0.5, 0.5])
    return u + jitter * torch.eye(u.shape[0])


def _rel(a, b) -> float:
    """max |a − b| over max |b|, in float64."""
    a, b = torch.as_tensor(a).detach().double(), torch.as_tensor(b).detach().double()
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-300))


def _slice_data(spatial_gibbs, argv, dev):
    """The slice's normalised UIB data and its experiment config."""
    from nonstationary_precip_tpu_torch.train.config import ExperimentConfig

    cfg = ExperimentConfig(lr=0.01, max_iters=5000).parse_args([*argv, "--device", "cuda"])
    _, x, y = spatial_gibbs.load_uib_spatial()
    x_norm = (x - x.mean(0)) / x.std(0, ddof=1)
    return cfg, x_norm, (y - y.mean()) / y.std(ddof=1)


def gate_spec(largen_out) -> dict:
    """The large-N gate's trained pose in the form a spawned rank receives
    (``_world_pose`` makes the paths' tensors from it): log ℓ per point and
    log σ²."""
    p = largen_out["params"]
    return {"gate": {"log_ell_pp": np.asarray(torch.as_tensor(p["log_ell_pp"]).cpu(), np.float32),
                     "log_noise": float(torch.as_tensor(p["log_noise"]))}}


def phase_parallel(largen_out, dev, dev_name: str) -> dict:
    """The nine paths of JAX's ``__graft_entry__.dryrun_multichip`` at world
    1 on NCCL (one card; ``--world P`` runs the same ``w_*`` functions on P
    cards): each path on the group, its launches held to
    ``world_launches``, then without a mesh on the card in float32 and in
    float64 (WORLD_F64_ON_CARD, else the CPU), the sparse bound and the CG
    paths also in float64 on the group, all held by ``hold_path``: at
    world 1 every collective is a copy, so the paths of WORLD1_BITWISE are
    one device's bit for bit.  Returns the main-path launches by kernel."""
    f32, f64 = torch.float32, torch.float64
    spec = gate_spec(largen_out)
    totals, rows = {}, {}
    t_all = time.perf_counter()
    with world1(dev) as mesh:
        want = "nccl" if dev.type == "cuda" else "gloo"
        check(mesh.backend == want and mesh.size == 1, f"world 1 on {want}: {mesh.backend}, {mesh.size}")
        for name in WORLD_PATHS:
            torch.cuda.synchronize()
            reset_launches()
            t0 = time.perf_counter()
            res = w_cholesky(mesh) if name == "cholesky" else WORLD_RUNS[name](mesh, 1, dev, f32, spec)
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            got = check_launches(world_launches(name, 1, {"results": {name: res}}), f"parallel {name}")
            for k, v in got.items():
                totals[k] = totals.get(k, 0) + v
            if name == "cholesky":
                rows[name] = {"seconds": seconds, **res}
                continue
            run = WORLD_RUNS[name]
            one = _tree_cpu(run(None, 1, dev, f32, spec))
            ref = _tree_cpu(run(None, 1, world_f64_device(name, dev), f64, spec))
            ranks64 = [_tree_cpu(run(mesh, 1, dev, f64, spec))] if name in WORLD_F64_ON_CARD else None
            rows[name] = {"seconds": seconds,
                          **hold_path(f"parallel {name}", name, 1, [_tree_cpu(res)], one, ref, ranks64)}
    emit("parallel", world=1, backend=want, rows=rows, launches=_nonzero(totals),
         seconds=time.perf_counter() - t_all, device=dev_name)
    return totals


def phase_k2_rows(matvec, payloads, dev) -> dict:
    """K2 on the K2_ROW_BLOCKS (N/4, N) row blocks of the gate's trained
    payload at N = LARGEN_N (each rank's product in a 4-card run): each
    block against its plain version (K2's band) and float64, and their
    concatenation against the whole launch (reported: bit for bit or not;
    the column splits follow the row count, so the sums' order may
    differ).  Times each block beside its plain version and its bound."""
    x, ell = payloads["trained"]
    v = torch.randn(LARGEN_N, 9, generator=torch.Generator().manual_seed(53)).to(dev)
    nb = LARGEN_N // K2_ROW_BLOCKS
    whole = matvec.gibbs_gram_matvec_cuda(x, ell, x, ell, v)
    blocks, errs = [], {}
    for r in range(K2_ROW_BLOCKS):
        sl = slice(r * nb, (r + 1) * nb)
        k = matvec.gibbs_gram_matvec_cuda(x[sl], ell[sl], x, ell, v)
        p = matvec.gibbs_gram_matvec_plain(x[sl], ell[sl], x, ell, v)
        ref = gibbs_matvec_f64(x[sl], ell[sl], x, ell, v)
        torch.cuda.synchronize()
        err = (k - p).abs()
        ek, ep = float((k.double() - ref).abs().max()), float((p.double() - ref).abs().max())
        largest = float(ref.abs().max())
        check(bool((err <= K2_ATOL + K2_RTOL * p.abs()).all()), f"K2 row block {r} within rtol {K2_RTOL} / atol {K2_ATOL}")
        check(ek <= 2 * ep + K6_FLOOR * largest, f"K2 row block {r} vs float64 {ek:.3g} within 2x plain's {ep:.3g}")
        errs[f"block{r}"] = {"max_abs_err": float(err.max()), "kernel_vs_f64": ek, "plain_vs_f64": ep,
                             "largest": largest}
        blocks.append(k)
    cat = torch.cat(blocks)
    diff = float((cat - whole).abs().max())
    check(diff <= K2_ATOL + K2_RTOL * float(whole.abs().max()), f"K2 row blocks against the whole launch: {diff:.3g}")
    xs, ls = x[:nb].contiguous(), ell[:nb].contiguous()
    t = timed_pair(lambda: matvec.gibbs_gram_matvec_cuda(xs, ls, x, ell, v),
                   lambda: matvec.gibbs_gram_matvec_plain(xs, ls, x, ell, v), N_TIMED_GRAM)
    fp32_ms, fp32_by = bound(matvec.matvec_ops(nb, LARGEN_N, 2, 9), 4 * (2 * nb * 2 + 2 * LARGEN_N * 2 + LARGEN_N * 9
                                                                          + nb * 9))
    sfu_ms = matvec.matvec_sfu_ops(nb, LARGEN_N, 2) / (16 * torch.cuda.get_device_properties(dev).multi_processor_count
                                                       * sm_clock_mhz() * 1e6) * 1e3
    b_ms, b_by = max((fp32_ms, fp32_by), (sfu_ms, "operations"))
    out = {"blocks": K2_ROW_BLOCKS, "shape": [nb, LARGEN_N, 2, 9], "errors": errs, "cat_vs_whole_max_abs": diff,
           "cat_bitwise_whole": bool(torch.equal(cat, whole)), "bound_ms": b_ms, "bound_by": b_by, **t}
    emit("k2_rows", **out)
    return out


@contextlib.contextmanager
def recorded(module, name: str):
    """Every call of ``module.name`` inside the block, as (inputs, output)
    copies, the function itself (its launch count included) unchanged."""
    fn, calls = getattr(module, name), []

    def wrapper(*args):
        out = fn(*args)
        calls.append((tuple(a.detach().clone() for a in args), out.detach().clone()))
        return out

    setattr(module, name, wrapper)
    try:
        yield calls
    finally:
        setattr(module, name, fn)


def demo_kernels_held(what: str, chols, solves) -> dict:
    """A demo's own K10a and K11 launches, each on the inputs the demo gave
    it.  A finite factor by K5's criteria (``chol_errors``: float64, the
    backward-error ratio) beside its plain version, with κ₂(H) reported, H
    the unit-diagonal scaling of the input.  A failed try of
    safe_cholesky's ladder only where no float32 Cholesky is sure to
    succeed: λ_min(H) ≤ nγ_(n+1)/(1 − γ_(n+1)) (Demmel's condition,
    Higham, Theorem 10.7); whether the plain version failed too is
    reported.  A solve by its backward-error ratio ≤ 1 (Higham, Theorem
    8.5), and against its plain version and float64 (``check_f64``) with
    the floor max(DENSE_FLOOR, κ₂(L)·2⁻²⁴): at κ₂(L)·2⁻²⁴ = 2.7e-3 (the
    matrix-normal demo's L_U) the forward errors of two backward-stable
    substitutions are not ordered (on the card K11's was 2.02 times
    cuBLAS's, on the CPU its emulation's 0.82 times LAPACK's)."""
    from nonstationary_precip_tpu_torch.ops import chol_blocked, trsm

    out = {}
    for i, ((a,), l) in enumerate(chols):
        a64 = torch.tril(a.double()) + torch.tril(a.double(), -1).T
        d = torch.rsqrt(torch.diagonal(a64))
        ev = torch.linalg.eigvalsh(d[:, None] * a64 * d[None, :])
        lam = float(ev[0])
        kappa = float(ev[-1]) / lam if lam > 0 else float("inf")
        if bool(torch.isfinite(l).all()):
            out[f"K10a_{i}"] = chol_errors(f"{what} K10a call {i}", lambda _: l, a,
                                           {"plain": chol_blocked.blocked_cholesky_plain})
            out[f"K10a_{i}"]["kappa_h"] = kappa
            continue
        n = a.shape[-1]
        gamma = (n + 1) * 2.0**-24 / (1 - (n + 1) * 2.0**-24)
        sure = n * gamma / (1 - gamma)
        check(lam <= sure, f"{what} K10a call {i} failed where float32 Cholesky must succeed: "
                           f"λ_min(H) {lam:.3g} > {sure:.3g}")
        out[f"K10a_{i}"] = {"failed": True, "lambda_min_h": lam, "sure_above": sure,
                            "plain_failed": not bool(torch.isfinite(chol_blocked.blocked_cholesky_plain(a)).all())}
    for i, ((l, b), x) in enumerate(solves):
        ref = torch.linalg.solve_triangular(l.double(), b.double(), upper=False)
        ratio = backward_ratio(l, b, x)
        check(ratio <= 1.0, f"{what} K11 call {i} backward error ratio {ratio:.3g} <= 1")
        kappa = float(torch.linalg.cond(l.double()))
        floor = max(DENSE_FLOOR, kappa * 2.0**-24)
        e = out[f"K11_{i}"] = check_f64(f"{what} K11 call {i}", x, trsm.trsm_plain(l, b), ref, floor)
        e.update(shape=list(b.shape), bound_ratio=ratio, kappa_l=kappa, floor=floor)
    return out


def phase_parallel_examples(dev, dev_name: str) -> dict:
    """The two parallel quickstarts at their defaults on this process's
    world-1 NCCL group (the sharded one also with --gibbs, K2's local
    matvec) and the two plotting demos' numbers, each ending in "ok" (the
    demos say that no figure is drawn where matplotlib is missing), with
    their launches counted: the DP quickstart K4 and K7 (5 steps, the
    parity's value and its replay), the Gibbs quickstart K2 once an
    iteration (25 steps of 32, the parity's 32, the posterior's 60), the
    stationary one none (JAX's plain row block), the demos DEMO_LAUNCHES:
    K10a (the 900² Cholesky factors and their ladders' tries) and K11 (the
    matrix-normal log-density's solve), each launch held at the demo's own
    shape (``demo_kernels_held``)."""
    from nonstationary_precip_tpu_torch.examples import (matrix_normal_demo, mv_gibbs_demo, quickstart_dataparallel,
                                                         quickstart_sharded_largen)
    from nonstationary_precip_tpu_torch.ops import chol_blocked, trsm

    q = quickstart_sharded_largen
    dp_calls = 5 + 1 + 1
    cases = (("dataparallel", lambda _: quickstart_dataparallel.main(),
              {"svgp_precompute": dp_calls, "elbo_data_term_fwd": dp_calls, "elbo_data_term_bwd": dp_calls - 1}),
             ("sharded_largen", lambda _: q.main(), {}),
             ("sharded_largen_gibbs", lambda _: q.main(gibbs=True),
              {"gibbs_matvec": 25 * q.ITERS + q.ITERS + q.POST_ITERS}),
             ("mv_gibbs_demo", lambda d: mv_gibbs_demo.main(d, dev="cuda"), DEMO_LAUNCHES["mv_gibbs_demo"]),
             ("matrix_normal_demo", lambda d: matrix_normal_demo.main(d, dev="cuda"),
              DEMO_LAUNCHES["matrix_normal_demo"]))
    rows, totals = {}, {}
    with world1(dev), tempfile.TemporaryDirectory() as d:
        for name, call, want in cases:
            reset_launches()
            t0 = time.perf_counter()
            with (contextlib.redirect_stdout(io.StringIO()) as printed,
                  recorded(chol_blocked, "blocked_cholesky_cuda") as chols, recorded(trsm, "trsm_cuda") as solves):
                out = call(d)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            lines = printed.getvalue().splitlines()
            check(lines[-1:] == ["ok"], f"{name} ends with ok: {lines[-3:]}")
            got = check_launches(want, name)
            held = {}
            if name in DEMO_LAUNCHES:
                check(sum("is not drawn" in ln or ln.startswith("wrote ") for ln in lines) == 1,
                      f"{name}: a figure drawn or said not to be: {lines}")
                held = {"held": demo_kernels_held(name, chols, solves)}
            for k, v in got.items():
                totals[k] = totals.get(k, 0) + v
            numbers = {k: v for k, v in out.items() if isinstance(v, (int, float, bool))} if isinstance(out, dict) else {}
            rows[name] = {"seconds": wall, "launches": _nonzero(got), "printed": lines[-4:], **numbers, **held}
    emit("parallel_examples", rows=rows, launches=_nonzero(totals), device=dev_name)
    return totals


# ---------------------------------------------------------------------------
# parallel/ on P cards over NCCL (--world P)
# ---------------------------------------------------------------------------

#: ``--world P``: JAX's ``dryrun_multichip`` sizes at P devices
#: (``__graft_entry__.py:93, 140, 177, 206-213, 229, 259``), each at the
#: world-1 phase's size where that divides over P.  Cut to JAX's P-scaled
#: size: ``fit_splits`` takes WORLD_SPLITS splits (the slice's 10 do not
#: divide over 4; ``train/vmapped.py`` raises where K % P ≠ 0, as JAX's
#: does).  Kept: the 394 marginal sites (``sharded_marginals`` pads them to a
#: multiple of P, as JAX's 5P + 3 test points are padded) and the sparse
#: bound's 316 rows (316 = 4 · 79).  The row-sharded SGPR, which the world-1
#: phase leaves to the CPU tests, runs at JAX's 128·P rows (z every 16th).
WORLD_SPLITS = 8
WORLD_SGPR_ROWS = 128
WORLD_DEADLINE = 900.0  # seconds the P ranks may take in all (parallel.launch's deadline)
#: A float32 result of P ranks against the float64 one-device path: within
#: WORLD_GAP times the float32 one-device path's own gap to float64, plus
#: PAR_SPARSE_F32_FLOOR of the result's scale (``_gap``, ``_gap_scales``).  P
#: ranks sum in another order than one card, so the two float32 results are
#: two roundings of one computation, each about one float32 gap from
#: float64; the ratio of the two gaps spreads (1.6 on one leaf of DP DSVI's
#: gradient at P = 2 on the CPU, and CG and 50 Adam steps amplify rounding),
#: so 4 leaves room for it, while a lost shard or a gradient counted P times
#: (an error of 1/P of the value or more) still fails by orders of magnitude.
WORLD_GAP = 4
#: at world 1 the float32 results differ from one device's only where the
#: sharded algebra is not the one-device one (the SGPR and sparse Gibbs
#: bounds' per-shard terms): twice one device's gap, as two roundings of
#: one computation
WORLD1_GAP = 2
#: the paths whose world-1 run is one device's bit for bit (every
#: collective a copy, the same operations in the same order)
WORLD1_BITWISE = ("dp", "marginals", "fit_splits", "sharded_cg")
#: where each path's float64 counterpart runs: K1, K4 and K7 take float32
#: only and raise on a float64 CUDA tensor, so their paths' float64 runs on
#: the CPU (plain versions); the sparse bound and the CG paths run theirs on
#: the card through the plain Gram and row blocks (K9's and K2's gates take
#: float32 only), on the ranks too, where each is held to one device's
#: float64 (PAR_SPARSE_F64, PAR_CG_F64)
WORLD_F64_ON_CARD = ("gibbs_sparse", "sharded_cg")
WORLD_PATHS = ("dp", "sgpr", "gibbs_sparse", "marginals", "cholesky", "fit_splits", "sharded_cg")
#: the paths run once untimed and uncounted on each rank, and on card 0
#: before its one-device run, so that no path's seconds hold a first call
WORLD_WARM = ("dp", "sgpr", "gibbs_sparse", "marginals", "fit_splits", "sharded_cg")
WORLD_QUICKSTARTS = ("dataparallel", "sharded_largen", "sharded_largen_gibbs")


def _tree_cpu(t):
    """A nested result with every tensor moved to the CPU in float64 (exact
    for float32), so it crosses ``torch.save`` small and compares anywhere."""
    if isinstance(t, torch.Tensor):
        return t.detach().to("cpu", torch.float64)
    if isinstance(t, dict):
        return {k: _tree_cpu(v) for k, v in t.items()}
    if isinstance(t, (list, tuple)):
        return [_tree_cpu(v) for v in t]
    return t


def _tensor_leaves(tree, prefix: str = "") -> list:
    """[(dotted name, tensor)] of a nested result; other leaves skipped."""
    if isinstance(tree, torch.Tensor):
        return [(prefix, tree)]
    if isinstance(tree, dict):
        return [leaf for k, v in tree.items() for leaf in _tensor_leaves(v, f"{prefix}.{k}" if prefix else str(k))]
    if isinstance(tree, (list, tuple)):
        return [leaf for i, v in enumerate(tree) for leaf in _tensor_leaves(v, f"{prefix}[{i}]")]
    return []


def _world_sync(mesh):
    """Every rank's card idle and every rank here: the edge of a timed window."""
    import torch.distributed as dist

    if mesh.device.type == "cuda":
        torch.cuda.synchronize(mesh.device)
        dist.barrier(group=mesh.group, device_ids=[mesh.device.index])
    else:
        dist.barrier(group=mesh.group)


def w_dp(mesh, p: int, dev, dtype, spec=None) -> dict:
    """Data-parallel DSVI at bench.py's shapes, B = PAR_DGP[0] a shard:
    PAR_DGP_STEPS Adam steps of ``dp_value_and_grad`` on P ranks, or (mesh
    None) of the mean of the P shard losses on one device, from one init
    and one ε stack: the first step's loss and gradients, and the loss
    trace (``trace``, reported, not held: a dozen of the deep GP's
    gradients are zero to rounding at init, 1e-17 in float64 and exactly 0
    in float32 or not, and Adam's first step normalises each to ±lr, so
    the traces of two roundings part by ~1e-3 from step 1 on)."""
    from nonstationary_precip_tpu_torch.experiments.deepgp_spatial import draw_eps
    from nonstationary_precip_tpu_torch.models.deep_gp import DeepGP
    from nonstationary_precip_tpu_torch.parallel import dp_value_and_grad

    b, m, s = PAR_DGP
    rng = np.random.default_rng(11)
    x = torch.tensor(rng.standard_normal((b * p, 2)), dtype=torch.float32).to(dev, dtype)
    y = torch.sin(x[:, 0])
    stack = draw_eps(rng, (p, PAR_DGP_STEPS, s), 2, b)  # per layer (P, T, S, O, B)
    model = DeepGP.create(torch.Generator().manual_seed(5), input_dims=2, num_layers=2, num_inducing=m).to(dev, dtype)
    params = [q for q in model.parameters() if q.requires_grad]
    opt = torch.optim.Adam(params, lr=0.01, betas=(0.9, 0.999), eps=1e-8)

    def loss_fn(mdl, xb, yb, e):
        return mdl.loss(xb, yb, num_data=b * p, eps=e)

    vag = dp_value_and_grad(loss_fn, mesh) if mesh is not None else None
    losses, grads0 = [], None
    for t in range(PAR_DGP_STEPS):
        def eps(r):
            return [torch.tensor(layer[r, t]).to(dev, dtype) for layer in stack]

        if mesh is not None:
            loss, grads = vag(model, mesh.rows(x), mesh.rows(y), eps(mesh.rank))
        else:
            loss = sum(loss_fn(model, x[r * b:(r + 1) * b], y[r * b:(r + 1) * b], eps(r)) for r in range(p)) / p
            grads = torch.autograd.grad(loss, params)
        grads0 = grads0 if grads0 is not None else [g.detach().clone() for g in grads]
        for q, g in zip(params, grads):
            q.grad = g
        opt.step()
        losses.append(loss.detach())
    return {"loss0": losses[0], "grads0": grads0, "trace": torch.stack(losses)}


def w_sgpr(mesh, p: int, dev, dtype, spec=None) -> dict:
    """The row-sharded SGPR bound (``sharded_sgpr_value_and_grad``) at
    JAX's dryrun size, WORLD_SGPR_ROWS·P rows, z every 16th row, against
    ``SGPR.loss`` on one device: value and every gradient."""
    from nonstationary_precip_tpu_torch.kernels.base import Scale
    from nonstationary_precip_tpu_torch.kernels.inducing import nystrom_root
    from nonstationary_precip_tpu_torch.kernels.stationary import RBF
    from nonstationary_precip_tpu_torch.models.sgpr import SGPR
    from nonstationary_precip_tpu_torch.parallel import sharded_sgpr_value_and_grad

    rng = np.random.default_rng(7)
    x = torch.tensor(rng.normal(size=(WORLD_SGPR_ROWS * p, 2)), dtype=torch.float32).to(dev, dtype)
    y = torch.sin(x[:, 0])
    kern = Scale.create(RBF.create(2, lengthscale=1.1), outputscale=0.8)
    model = SGPR.create(kern, x[::16].float().cpu(), noise=0.1).to(dev, dtype)
    params = [q for q in model.parameters() if q.requires_grad]

    def root_fn(mdl, x_s):
        return nystrom_root(mdl.kernel(x_s, mdl.z), mdl.kernel(mdl.z))[0]

    def trace_fn(mdl, x_s, root):
        return mdl.kernel.diag(x_s) - torch.sum(root * root, dim=-1)

    if mesh is not None:
        loss, grads = sharded_sgpr_value_and_grad(root_fn, trace_fn, mesh)(model, mesh.rows(x), mesh.rows(y))
    else:
        loss = model.loss(x, y)
        grads = torch.autograd.grad(loss, params)
    return {"loss": loss.detach(), "grads": list(grads)}


def w_gibbs_sparse(mesh, p: int, dev, dtype, spec=None) -> dict:
    """``gibbs_sparse_sharded_loss`` on split 0's 316 rows at M = 250, both
    ``scale_correction``s, or ``GibbsSparseGP.loss`` on one device: value
    and every trainable gradient by name (K9: K_xz and K_zz, in float32)."""
    from nonstationary_precip_tpu_torch.experiments import spatial_gibbs
    from nonstationary_precip_tpu_torch.models.gibbs_gp import gibbs_sparse_sharded_loss

    cfg, x_norm, y_norm = _slice_data(spatial_gibbs, ["--inference", "sparse"], dev)
    model, (x_tr, y_tr, _, _) = spatial_gibbs.make_split(x_norm, y_norm, 0, cfg, torch.float32, dev)
    model, x_tr, y_tr = model.to(dtype), x_tr.to(dtype), y_tr.to(dtype)
    named = [(n, q) for n, q in model.named_parameters() if q.requires_grad]
    out = {}
    for sc in (False, True):
        model.scale_correction = sc
        if mesh is not None:
            loss = gibbs_sparse_sharded_loss(mesh)(model, mesh.rows(x_tr), mesh.rows(y_tr))
        else:
            loss = model.loss(x_tr, y_tr)
        grads = torch.autograd.grad(loss, [q for _, q in named])
        out[f"scale_correction_{sc}"] = {"loss": loss.detach(), "grads": {n: g for (n, _), g in zip(named, grads)}}
    out["shape"] = [x_tr.shape[0] // (mesh.size if mesh is not None else 1), model.z.shape[-2]]  # rows a rank, M
    return out


def w_marginals(mesh, p: int, dev, dtype, spec=None) -> dict:
    """``sharded_marginals`` of split 0's exact Gibbs model at its init pose
    over the 394 sites (padded to a multiple of P), or its predictive on
    one device (K9)."""
    from nonstationary_precip_tpu_torch.experiments import spatial_gibbs
    from nonstationary_precip_tpu_torch.parallel import sharded_marginals

    cfg, x_norm, y_norm = _slice_data(spatial_gibbs, [], dev)
    model, (x_tr, y_tr, _, _) = spatial_gibbs.make_split(x_norm, y_norm, 0, cfg, torch.float32, dev)
    model, x_tr, y_tr = model.to(dtype), x_tr.to(dtype), y_tr.to(dtype)
    x_all = torch.as_tensor(x_norm, dtype=torch.float32).to(dev, dtype)

    def predict_fn(mdl, xs):
        post = mdl.predictive(x_tr, y_tr, xs)
        return post.mean, post.var

    with torch.no_grad():
        mean, var = (sharded_marginals(predict_fn, mesh)(model, x_all) if mesh is not None
                     else predict_fn(model, x_all))
    return {"mean": mean, "var": var, "shape": [-(-x_all.shape[0] // p) if mesh is not None else x_all.shape[0],
                                                x_tr.shape[0]]}  # test rows a rank, training rows


def w_fit_splits(mesh, p: int, dev, dtype, spec=None, splits=range(WORLD_SPLITS)) -> dict:
    """``fit_splits(mesh=)`` on the Gibbs slice's ``splits`` (WORLD_SPLITS)
    for PAR_FIT_STEPS steps and ``eval_splits(mesh=)`` (K1 and K9 once a
    step on each rank's K/P splits, K9 twice in the evaluation), or both
    without a mesh: the loss trace, the trained lengthscales, RMSE and
    NLPD."""
    from nonstationary_precip_tpu_torch.experiments import spatial_gibbs
    from nonstationary_precip_tpu_torch.models.gibbs_gp import gibbs_map_loss_batched
    from nonstationary_precip_tpu_torch.train.vmapped import Stacked, eval_splits, fit_splits

    cfg, x_norm, y_norm = _slice_data(spatial_gibbs, [], dev)
    splits = [spatial_gibbs.make_split(x_norm, y_norm, s, cfg, torch.float32, dev) for s in splits]
    models = [s[0].to(dtype) for s in splits]
    x_tr, y_tr, x_te, y_te = ([t.to(dtype) for t in c] for c in zip(*[s[1] for s in splits]))
    pre = spatial_gibbs.build_prior(cfg, dtype, dev).gram_pre(torch.stack(x_tr))
    res = fit_splits(models, lambda m, a, b, q: m.loss(a, b, q), x_tr, y_tr, Stacked(pre), lr=cfg.lr,
                     num_steps=PAR_FIT_STEPS, chunk=PAR_FIT_STEPS, batched_loss=gibbs_map_loss_batched, mesh=mesh)
    rmse, nlpd = eval_splits(res.model, spatial_gibbs._eval_one(torch.tensor(1.0, dtype=dtype, device=dev)), x_tr,
                             y_tr, x_te, y_te, mesh=mesh)
    return {"losses": torch.as_tensor(np.asarray(res.losses)), "log_ell": res.model.log_ell.detach(), "rmse": rmse,
            "nlpd": nlpd}


def _world_pose(spec: dict, dev, dtype):
    """(aug, y, σ², probe draws) of the large-N gate at its trained pose
    (``gate_spec``) in ``dtype``: the packed payload [x, log ℓ], the
    unscaled Gram (the JAX builder's) with the trained noise."""
    from nonstationary_precip_tpu_torch.experiments import gibbs_largen

    cfg = gibbs_largen.LargeNConfig(n=LARGEN_N, device="cuda")
    x, y = (t.to(dev) for t in gibbs_largen._data(LARGEN_N))
    aug = torch.cat([x, torch.as_tensor(spec["gate"]["log_ell_pp"], device=dev)], dim=1)
    s2 = torch.exp(torch.as_tensor(spec["gate"]["log_noise"], device=dev))
    noise = tuple(torch.as_tensor(a, device=dev) for a in gibbs_largen.probe_draws(cfg.seed, PAR_CG_RANK, LARGEN_N))
    return aug.to(dtype), y.to(dtype), s2.to(dtype), tuple(t.to(dtype) for t in noise)


def w_sharded_cg(mesh, p: int, dev, dtype, spec: dict) -> dict:
    """At the gate's trained pose (N = LARGEN_N, rank PAR_CG_RANK,
    PAR_CG_ITERS iterations): the MLL and its x, y and σ² gradients through
    ``sharded_cg_mll`` with ``packed_gibbs_local_matvec(2)`` (K2 on each
    rank's (N/P, N) row block) or ``lazy_cg_mll`` through K2 on one device;
    the default path at PAR_DEFAULT_N (materialised row blocks, no kernel);
    ``make_sharded_chunked_mll`` (P ranks only; held to the one-device MLL);
    the posterior state with the Nyström factor (rank, shift PAR_NYSTROM)
    and a PAR_QUERY-point query.  float64 runs the plain row blocks
    (``lazy_cg``'s default builder, 2048 rows a block on one device).  The
    default path on one device takes the ranks' (N/P)-row panels, so that
    at world 1 it is the sharded one's bit for bit."""
    from nonstationary_precip_tpu_torch.kernels.gibbs import packed_gibbs_cross
    from nonstationary_precip_tpu_torch.ops import matvec
    from nonstationary_precip_tpu_torch.ops.lazy_cg import lazy_cg_mll, lazy_posterior_query, lazy_posterior_state
    from nonstationary_precip_tpu_torch.parallel import (make_sharded_chunked_mll, sharded_cg_mll,
                                                         sharded_posterior_query, sharded_posterior_state)
    from nonstationary_precip_tpu_torch.parallel.sharded_cg import packed_gibbs_local_matvec

    aug0, y0, s20, noise = _world_pose(spec, dev, dtype)
    n = aug0.shape[0]
    cross = packed_gibbs_cross(2)
    local, whole, block = ((packed_gibbs_local_matvec(2), matvec.packed_gibbs_matvec_builder(2), n)
                           if dtype == torch.float32 else (None, None, min(n, 2048)))
    kw = dict(max_iters=PAR_CG_ITERS, tol=1e-6, precond_rank=PAR_CG_RANK, cross_fn=cross)
    out = {}

    def mll(aug, y, s2, nz, builder: bool, info):
        if mesh is not None:
            return sharded_cg_mll(None, aug, y, nz, s2, mesh, local_matvec_builder=local if builder else None,
                                  info=info, **kw)
        return lazy_cg_mll(None, aug, y, nz, s2, block=block if builder else aug.shape[0] // p,
                           matvec_builder=whole if builder else None, info=info, **kw)

    leaves = [t.detach().clone().requires_grad_() for t in (aug0, y0, s20)]
    info = {}
    val = mll(*leaves, noise, True, info)
    out["mll"] = {"value": val.detach(), "grads": list(torch.autograd.grad(val, leaves))}
    out["iters"] = {"mll": info["iters"]}

    nd = min(PAR_DEFAULT_N, n)
    leaves = [t.detach().clone().requires_grad_() for t in (aug0[:nd], y0[:nd], s20)]
    vd = mll(*leaves, (noise[0], noise[1][:nd]), False, {})
    out["default_path"] = {"value": vd.detach(), "grads": list(torch.autograd.grad(vd, leaves))}

    if mesh is not None:
        chunked = make_sharded_chunked_mll(mesh, PAR_CG_ITERS // 2, 2, 1e-6, PAR_CG_RANK, "pivchol", 1.0, cross,
                                           local)
        cv, _, cg = chunked.value_and_grad(None, aug0, y0, s20, noise)
        out["chunked"] = {"value": cv.detach(), "grads": [cg[1], cg[2], cg[3]]}
        out["iters"]["chunked"] = chunked.iters

    rank, shift = PAR_NYSTROM
    gen = torch.Generator().manual_seed(47)
    xt = torch.cat([6 * torch.rand(PAR_QUERY, 2, generator=gen) - 3, torch.zeros(PAR_QUERY, 2)], dim=1).to(dev, dtype)
    xt[:, 2:] = aug0[:, 2:].mean(0)
    skw = dict(max_iters=32, tol=1e-8, precond_rank=rank, precond="nystrom", precond_shift=shift, cross_fn=cross)
    qkw = dict(max_iters=16, tol=1e-6, precond_shift=shift, cross_fn=cross, return_info=True)
    if mesh is not None:
        st = sharded_posterior_state(None, aug0, y0, s20, mesh, local_matvec_builder=local, **skw)
        mean, cov, qinfo = sharded_posterior_query(st, xt, mesh, local_matvec_builder=local, **qkw)
    else:
        st = lazy_posterior_state(None, aug0, y0, s20, block=block, matvec_builder=whole, **skw)
        mean, cov, qinfo = lazy_posterior_query(st, xt, block=block, matvec_builder=whole, **qkw)
    out["posterior"] = {"alpha": st.alpha, "mean": mean, "cov": cov}
    out["iters"].update(state=st.iters, query=qinfo["iters"])
    out["query"] = {"broke": bool(qinfo["broke"]), "relres_max": float(qinfo["relres_max"]),
                    "alpha_relres": float(st.alpha_relres)}
    return out


def w_comm(mesh, spec: dict) -> dict:
    """One mBCG iteration's two parts on each rank at the gate's pose, timed
    on rank 0 with CUDA events after a barrier: K2 on the rank's (N/P, N)
    row block at R = 9 (the gate's 1 + 8 columns) and the tiled
    ``collectives.all_gather`` of its (N/P, 9) product, the iteration's only
    collective, beside NCCL's single-buffer ``all_gather_into_tensor`` of
    the same product (what the wrapper's list form and concatenation
    cost)."""
    import torch.distributed as dist

    from nonstationary_precip_tpu_torch.parallel.collectives import all_gather
    from nonstationary_precip_tpu_torch.parallel.sharded_cg import packed_gibbs_local_matvec

    aug, _, s2, _ = _world_pose(spec, mesh.device, torch.float32)
    mv = packed_gibbs_local_matvec(2)(None, mesh.rows(aug), aug, s2, mesh)
    v = torch.randn(aug.shape[0], 9, generator=torch.Generator().manual_seed(53)).to(mesh.device)
    _world_sync(mesh)
    k2 = block_times_ms(lambda: mv(v), N_TIMED_GRAM)
    part = mv(v)
    _world_sync(mesh)
    gather = block_times_ms(lambda: all_gather(part, mesh), N_TIMED)
    flat = torch.empty(mesh.size * part.shape[0], part.shape[1], device=mesh.device)
    _world_sync(mesh)
    into = block_times_ms(lambda: dist.all_gather_into_tensor(flat, part, group=mesh.group), N_TIMED)
    check(torch.equal(flat, all_gather(part, mesh)), "all_gather_into_tensor: the tiled all_gather's result")
    return {"rows": int(part.shape[0]), "n": int(aug.shape[0]), "r": 9, "k2_ms": statistics.median(k2),
            "all_gather_ms": statistics.median(gather), "all_gather_into_tensor_ms": statistics.median(into),
            "all_gather_bytes": 4 * aug.shape[0] * 9}


def w_cholesky(mesh) -> dict:
    """The 1-D sharded Cholesky at PAR_CHOL_N² and the 2-D one at
    PAR_CHOL2D_N² on JAX's (P/2, 2) mesh (``__graft_entry__.py:211``; 1 × 1
    at P = 1), block PAR_BLOCK, on the dryrun's r·rᵀ/128 + 2I, and both on
    F-P8's input (``fp8_input``) at PAR_FP8_N.  Each factor gathered whole
    and held on rank 0 by K5's criteria (``chol_errors``); each timed on
    every rank at once (rank 0's CUDA events) beside one card's
    ``torch.linalg.cholesky`` of the whole matrix."""
    from nonstationary_precip_tpu_torch.parallel import make_mesh_2d, sharded_cholesky, sharded_cholesky_2d, tile
    from nonstationary_precip_tpu_torch.parallel.collectives import all_gather

    dev, p = mesh.device, mesh.size
    grid = (p // 2, 2) if p % 2 == 0 else (p, 1)
    mesh2 = make_mesh_2d(*grid)
    row_axis, col_axis = mesh2.axis

    def one_d(a):
        local = mesh.rows(a).contiguous()
        fn = sharded_cholesky(mesh, PAR_BLOCK)
        return (lambda: fn(local)), (lambda l: all_gather(l, mesh))

    def two_d(a):
        local = tile(mesh2, a).contiguous()
        fn = sharded_cholesky_2d(mesh2, PAR_BLOCK)
        return (lambda: fn(local)), (lambda l: all_gather(all_gather(l, mesh2, row_axis).mT.contiguous(), mesh2,
                                                          col_axis).mT)

    gen = torch.Generator().manual_seed(43)
    cases = []
    for name, n, form in (("sharded_cholesky", PAR_CHOL_N, one_d), ("sharded_cholesky_2d", PAR_CHOL2D_N, two_d)):
        r = torch.randn(n, 128, generator=gen).to(dev)
        cases.append((name, n, form, r @ r.T / 128 + 2.0 * torch.eye(n, device=dev), True))
    for jitter in PAR_FP8_JITTERS:
        a = fp8_input(jitter).to(dev)
        cases += [(f"sharded_cholesky_fp8_{jitter:g}", PAR_FP8_N, one_d, a, False),
                  (f"sharded_cholesky_2d_fp8_{jitter:g}", PAR_FP8_N, two_d, a, False)]
    out = {}
    for name, n, form, a, timed in cases:
        run, gather = form(a)
        l = gather(run())
        row = {"n": n, "block": PAR_BLOCK, "grid": list(grid) if "2d" in name else [p]}
        if mesh.rank == 0:
            row.update(chol_errors(f"world {p} {name}", lambda _: l, a, {}))
        del l
        _world_sync(mesh)
        if timed:
            row["ms"] = statistics.median(block_times_ms(run, 10))
            _world_sync(mesh)
            row["library_ms"] = statistics.median(block_times_ms(lambda: torch.linalg.cholesky(a), 10))
            _world_sync(mesh)
        out[name] = row
        del a
    return out


def w_quickstart(name: str, p: int) -> dict:
    """One parallel quickstart at its defaults on the caller's group (or, on
    one device, its world-1 group): what rank 0 printed and its numbers."""
    from nonstationary_precip_tpu_torch.examples import quickstart_dataparallel, quickstart_sharded_largen

    call = {"dataparallel": lambda: quickstart_dataparallel.main(),
            "sharded_largen": lambda: quickstart_sharded_largen.main(),
            "sharded_largen_gibbs": lambda: quickstart_sharded_largen.main(gibbs=True)}[name]
    with contextlib.redirect_stdout(io.StringIO()) as printed:
        out = call()
    return {"printed": printed.getvalue().splitlines(),
            **{k: v for k, v in out.items() if isinstance(v, (int, float, bool, list))}}


def world_rank(spec: dict) -> dict:
    """One rank of ``--world P`` (run by ``parallel.launch`` on its card):
    each path of WORLD_PATHS (those of WORLD_F64_ON_CARD also in float64),
    one mBCG iteration's parts (``w_comm``), then the parallel quickstarts,
    each between two ``_world_sync``s with the launch counts set to 0 just
    before it and read just after.  Returns, for the parent, each path's result (CPU,
    float64), launches and seconds, and rank 0's timings."""
    from nonstationary_precip_tpu_torch.parallel import make_mesh

    mesh = make_mesh()
    dev, p = mesh.device, mesh.size
    runs = {}
    for name in WORLD_PATHS:
        runs[name] = (lambda: w_cholesky(mesh)) if name == "cholesky" else (
            lambda name=name: WORLD_RUNS[name](mesh, p, dev, torch.float32, spec))
        if name in WORLD_F64_ON_CARD:
            runs[f"{name}_f64"] = lambda name=name: WORLD_RUNS[name](mesh, p, dev, torch.float64, spec)
    runs["comm"] = lambda: w_comm(mesh, spec)
    runs.update({f"quickstart_{q}": (lambda q=q: w_quickstart(q, p)) for q in WORLD_QUICKSTARTS})
    out = {"rank": mesh.rank, "size": p, "backend": mesh.backend, "device": str(dev), "results": {},
           "launches": {}, "seconds": {}}
    if dev.type == "cuda":
        out["card"] = torch.cuda.get_device_name(dev)
    for name in WORLD_WARM:  # the process's first calls (communicators, handles, libraries) go untimed
        runs[name]()
    for name, run in runs.items():
        _world_sync(mesh)
        reset_launches()
        t0 = time.perf_counter()
        res = run()
        _world_sync(mesh)
        out["seconds"][name] = time.perf_counter() - t0
        out["launches"][name] = launch_counts()
        out["results"][name] = _tree_cpu(res)
    return out


def world_launches(name: str, p: int, rank_out: dict) -> dict:
    """What each rank of a P-rank run must have launched on ``name``: a
    step's K4 and K7 (dp), K9 on each Gram its gate admits (N₁·N₂ ≥ 128²,
    ``gibbs_gram.MIN_ELEMS``, as JAX's): the sparse bound's K_xz (N/P × M)
    and K_zz for each scale_correction, the predictive's K_xx, K_sx and
    K_ss at the rank's ⌈394/P⌉ test rows (K_ss of 99² falls under it at P =
    4, where one card's 394² does not), K1 and
    K9 once a step and K9 twice in the evaluation (fit_splits), K2 once an
    mBCG iteration and column block (sharded_cg, from the rank's own
    iteration counts), K4 and K7 in the DP quickstart (its 5 steps, its P
    shard replays forward only and its last value and gradient), K2 in the
    Gibbs quickstart (25 steps of ITERS, the parity's ITERS, the
    posterior's POST_ITERS); none elsewhere (the Cholesky is the library's,
    as JAX's; the stationary quickstart runs JAX's plain row block)."""
    from nonstationary_precip_tpu_torch.examples import quickstart_sharded_largen as q
    from nonstationary_precip_tpu_torch.ops import matvec

    t = PAR_DGP_STEPS
    if name == "dp":
        return {"svgp_precompute": t, "elbo_data_term_fwd": t, "elbo_data_term_bwd": t}
    if name in ("gibbs_sparse", "marginals"):
        from nonstationary_precip_tpu_torch.ops.gibbs_gram import MIN_ELEMS

        rows, n = rank_out["results"][name]["shape"]
        pairs = ((rows, n), (n, n)) * 2 if name == "gibbs_sparse" else ((n, n), (rows, n), (rows, rows))
        return {"gibbs_gram": sum(a * b >= MIN_ELEMS for a, b in pairs)}
    if name == "fit_splits":
        return {"chol_inv_batched": PAR_FIT_STEPS, "gibbs_gram": PAR_FIT_STEPS + 2}
    if name == "sharded_cg":
        it = rank_out["results"]["sharded_cg"]["iters"]
        return {"gibbs_matvec": it["mll"] + it["chunked"] + it["state"] + it["query"] * -(-PAR_QUERY // matvec.MAX_R)}
    if name == "comm":
        return {"gibbs_matvec": 3 + N_TIMED_GRAM // 10 * 10 + 1}
    if name == "quickstart_dataparallel":
        return {"svgp_precompute": 5 + p + 1, "elbo_data_term_fwd": 5 + p + 1, "elbo_data_term_bwd": 5 + 1}
    if name == "quickstart_sharded_largen_gibbs":
        return {"gibbs_matvec": 25 * q.ITERS + q.ITERS + q.POST_ITERS}
    return {}


def _gap(what: str, ranks: list, one, ref, mult: float, scale: float) -> dict:
    """Every rank's float32 result the same bit for bit (each is replicated
    by the collectives) and within ``mult`` times the float32 one-device
    result's gap to float64, plus PAR_SPARSE_F32_FLOOR of ``scale`` (gaps
    max |a − ref| over ``scale``: the largest entry of the result, or of the
    whole gradient it belongs to); the gaps reported."""
    scale = max(scale, 1e-300)
    e_1 = float((one - ref).abs().max()) / scale
    e_r = [float((r - ref).abs().max()) / scale for r in ranks]
    limit = mult * e_1 + PAR_SPARSE_F32_FLOOR
    check(all(torch.equal(r, ranks[0]) for r in ranks[1:]), f"{what}: the ranks' results the same bit for bit")
    check(max(e_r) <= limit, f"{what}: P ranks' gap to float64 {max(e_r):.3g} within {mult}x one card's "
                             f"{e_1:.3g} + {PAR_SPARSE_F32_FLOOR}")
    return {"ranks_vs_f64": max(e_r), "one_vs_f64": e_1, "ranks_vs_one": float((ranks[0] - one).abs().max()) / scale,
            "bitwise_one": bool(torch.equal(ranks[0], one.to(ranks[0].dtype)))}


def _gap_scales(ref: dict) -> dict:
    """Each leaf's scale for ``_gap``: its own largest entry, or for a
    gradient leaf ("…grads[i]", "…grads0[i]", "…grads.name") the largest entry of the
    whole gradient, as JAX's dryrun holds max |Δ| over all its leaves.  A
    parameter whose gradient is zero to rounding (a dozen of the deep GP's
    at init: 1e-17 in float64, 1e-9 or 0 in float32) then counts as the
    noise it is."""
    group = {k: re.sub(r"^(.*?grads\d*)[.\[].*$", r"\1", k) for k in ref}
    top = {}
    for k, v in ref.items():
        top[group[k]] = max(top.get(group[k], 0.0), float(v.abs().max()))
    return {k: (top[group[k]] if group[k] != k else float(v.abs().max())) for k, v in ref.items()}


def world_f64_device(name: str, dev):
    """Where a path's float64 one-device counterpart runs."""
    return dev if name in WORLD_F64_ON_CARD else torch.device("cpu")


#: each path but the Cholesky's: ``run(mesh or None, P, device, dtype, spec)``
WORLD_RUNS = {"dp": w_dp, "sgpr": w_sgpr, "gibbs_sparse": w_gibbs_sparse, "marginals": w_marginals,
              "fit_splits": w_fit_splits, "sharded_cg": w_sharded_cg}


def hold_path(what: str, name: str, p: int, ranks: list, one: dict, ref: dict, ranks64=None) -> dict:
    """A path's results on P ranks (``_tree_cpu``'d, one a rank) against its
    one-device runs in float32 (``one``) and float64 (``ref``): every
    tensor leaf by ``_gap`` (WORLD1_GAP at world 1, WORLD_GAP at P), bit
    for bit ``one`` at world 1 on the paths of WORLD1_BITWISE, each rank's
    float64 run (``ranks64``, WORLD_F64_ON_CARD's paths) within
    PAR_SPARSE_F64 or PAR_CG_F64 of ``ref``, and the path's own checks: the
    SGPR's JAX criterion, the CG's iteration count and the query's
    convergence.  Returns the path's row."""
    row = {}
    if name == "sgpr":
        # JAX's own criterion for this path (__graft_entry__.py:169): |Δloss| < 1e-4, max |Δgrad| < 1e-2
        # against one device in float32; at 512 rows, z every 16th, float32's jitter keeps both float32
        # bounds far from float64 (0.44 of the loss on the card), so _gap alone says little here
        for r, o in enumerate(ranks):
            dl = float((o["loss"] - one["loss"]).abs())
            dg = max(float((x - y).abs().max()) for x, y in zip(o["grads"], one["grads"]))
            row.setdefault("jax_criterion", []).append({"dloss": dl, "dgrad": dg})
            check(dl < 1e-4 and dg < 1e-2, f"{what} rank {r}: |Δloss| {dl:.3g} < 1e-4, max |Δgrad| {dg:.3g} < 1e-2 "
                                           f"(JAX's dryrun criterion)")
    if name == "sharded_cg":
        for r, o in enumerate(ranks):
            check(o["iters"]["mll"] == PAR_CG_ITERS, f"{what} rank {r}: {o['iters']}")
            check(not o["query"]["broke"] and o["query"]["relres_max"] <= GATE_RELRES,
                  f"{what} rank {r}: the sharded query converged ({o['query']})")
        row.update(iters=ranks[0]["iters"], query=ranks[0]["query"], one_device_iters=one["iters"])
        for o in (one, ref):
            o["chunked"] = o["mll"]  # the chunked entry is held to the one-device MLL
    if name == "dp":
        # reported, held bit for bit at world 1 only: a dozen of the deep GP's gradients are zero to rounding
        # at init and Adam's first step normalises each to ±lr, so two roundings' traces part by ~1e-3
        row["trace"] = {"ranks": ranks[0]["trace"].tolist(), "one_device": one["trace"].tolist(),
                        "f64": ref["trace"].tolist()}
        if p == 1:
            check(torch.equal(ranks[0]["trace"], one["trace"]), f"{what}: the loss trace bit for bit one device's")
        ranks, one, ref = ([{k: v for k, v in o.items() if k != "trace"} for o in ranks],
                           *({k: v for k, v in o.items() if k != "trace"} for o in (one, ref)))
    leaves = {k: [dict(_tensor_leaves(o))[k] for o in ranks] for k, _ in _tensor_leaves(ranks[0])}
    one_l, ref_l = dict(_tensor_leaves(one)), dict(_tensor_leaves(ref))
    scales = _gap_scales(ref_l)
    mult = WORLD1_GAP if p == 1 else WORLD_GAP
    row["errors"] = {}
    for k, v in leaves.items():
        row["errors"][k] = _gap(f"{what} {k}", v, one_l[k], ref_l[k], mult, scales[k])
    if p == 1 and name in WORLD1_BITWISE:
        apart = [k for k, e in row["errors"].items() if not e["bitwise_one"]]
        check(not apart, f"{what}: bit for bit one device's at world 1 (apart: {apart})")
    if ranks64 is not None:
        row["f64"] = {}
        for r, o in enumerate(ranks64):
            for k, v in _tensor_leaves(o):
                tol = PAR_SPARSE_F64[k.rsplit(".", 1)[-1]] if name == "gibbs_sparse" else PAR_CG_F64
                e = _rel(v, ref_l[k])
                check(e <= tol, f"{what} {k} rank {r}: float64 {e:.3g} within {tol} of one device's float64")
                row["f64"][k] = max(row["f64"].get(k, 0.0), e)
    return row


def world_one_device(name: str, p: int, dev, dtype, spec: dict):
    """The one-device counterpart of a path on ``dev`` in ``dtype``: (result
    on the CPU in float64, its launches, its seconds)."""
    def call():
        return WORLD_RUNS[name](None, p, dev, dtype, spec)

    if name in WORLD_WARM and dtype == torch.float32:
        call()
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    res = call()
    torch.cuda.synchronize()
    return _tree_cpu(res), launch_counts(), time.perf_counter() - t0


def fit_splits_batch_probe(p: int, dev, rank0: dict) -> dict:
    """Where P ranks' ``fit_splits`` parts from one card's, though each
    split's work is its own: rank 0's K/P splits trained alone on card 0
    against rank 0's share of the P-rank run (bit for bit or not), and at
    the splits' init pose each batched step of ``gibbs_map_loss_batched``
    (the frozen prior's ``gram_pre``: cuSOLVER's Cholesky, a triangular
    solve and a product; K9's stacked Gram, K1's L and L⁻¹, α = L⁻¹y, the
    prior's log-density, the losses and their gradient) on all K splits against the
    same on the first K/P alone (bit for bit or not).  An op whose first
    K/P results change with the stack's size makes the runs part.
    Reported, not held."""
    from nonstationary_precip_tpu_torch.experiments import spatial_gibbs
    from nonstationary_precip_tpu_torch.models import gibbs_gp
    from nonstationary_precip_tpu_torch.train.vmapped import stack_modules

    kp = WORLD_SPLITS // p
    alone = _tree_cpu(w_fit_splits(None, p, dev, torch.float32, splits=range(kp)))
    share = {"losses": rank0["losses"][:, :kp], "log_ell": rank0["log_ell"][:kp], "rmse": rank0["rmse"][:kp],
             "nlpd": rank0["nlpd"][:kp]}
    out = {"splits": kp, "alone_vs_rank0_bitwise": {k: bool(torch.equal(alone[k], v)) for k, v in share.items()},
           "alone_vs_rank0_max_abs": {k: float((alone[k] - v).abs().max()) for k, v in share.items()}}
    cfg, x_norm, y_norm = _slice_data(spatial_gibbs, [], dev)
    splits = [spatial_gibbs.make_split(x_norm, y_norm, s, cfg, torch.float32, dev) for s in range(WORLD_SPLITS)]
    prior = spatial_gibbs.build_prior(cfg, torch.float32, dev)

    def steps(k):
        models = stack_modules([s[0] for s in splits[:k]])
        x, y = (torch.stack([s[1][i] for s in splits[:k]]) for i in (0, 1))
        pre = prior.gram_pre(x)
        gram = gibbs_gp.noisy_gibbs_gram(models, x)
        l, li = gibbs_gp.chol_inv_batched_safe(gram)
        loss = gibbs_gp.gibbs_map_loss_batched(models, x, y, pre)
        grads = torch.autograd.grad(loss.sum(), [q for q in models.parameters() if q.requires_grad])
        return {"prior_kinv": pre[0], "prior_logdet": pre[1], "gram": gram, "chol": l, "chol_inv": li,
                "alpha": (li @ y[..., None])[..., 0],
                "prior": models.prior.log_prob(x, models.log_ell, pre), "losses": loss, "grads": torch.cat(
                    [g.reshape(k, -1) for g in grads], dim=1)}

    whole, first = steps(WORLD_SPLITS), steps(kp)
    torch.cuda.synchronize()
    out["first_splits_bitwise"] = {k: bool(torch.equal(whole[k][:kp], first[k])) for k in whole}
    return out


def phase_world(p: int, dev, dev_name: str, spec: dict) -> dict:
    """``--world P``: the P ranks (``world_rank``, spawned by
    ``parallel.launch.start`` on cards 0..P−1 over NCCL, every kernel built
    beforehand by this process), then each path's one-device counterpart on
    card 0 in float32 and float64 from the same inputs, each rank's results
    held to them (``hold_path``) and its launches to ``world_launches``;
    at P > 1 ``fit_splits_batch_probe`` beside ``fit_splits``.  Emits a
    ``parallel`` line a path, then
    ``parallel_examples`` (the quickstarts, each also run on a world-1
    group on card 0 for its seconds) and a ``kernels`` line of every rank's
    launches.  Returns the per-rank launch totals."""
    from nonstationary_precip_tpu_torch.parallel.launch import start

    t0 = time.perf_counter()
    group = start("chip_smoke:world_rank", p, device=dev.type, args=(spec,), deadline=WORLD_DEADLINE, echo=False,
                  paths=[Path(__file__).resolve().parent])
    outs = group.join()
    ranks_s = time.perf_counter() - t0
    check([o["rank"] for o in outs] == list(range(p)) and all(o["size"] == p for o in outs),
          f"world {p}: ranks {[o['rank'] for o in outs]}")
    backend = outs[0]["backend"]
    check(all(o["backend"] == ("nccl" if dev.type == "cuda" else "gloo") for o in outs), f"world {p} backend {backend}")
    if dev.type == "cuda":
        check(len({o["device"] for o in outs}) == p, f"world {p}: one card a rank ({[o['device'] for o in outs]})")
    totals = [{} for _ in range(p)]

    def launches_held(name):
        per_rank = [outs[r]["launches"][name] for r in range(p)]
        for r, got in enumerate(per_rank):
            want = world_launches(name, p, outs[r])
            check(got == {k: want.get(k, 0) for k in got}, f"world {p} {name} rank {r}: launches {_nonzero(got)} == "
                                                           f"{want}")
            for k, v in got.items():
                totals[r][k] = totals[r].get(k, 0) + v
        return [_nonzero(g) for g in per_rank]

    failed = []

    def guarded(name, hold):
        """Run one path's checks; a failed check is kept, the next path
        held all the same, and the phase fails at its end with every
        failure (one multi-card call shows them all)."""
        try:
            hold()
        except RuntimeError as e:
            if not str(e).startswith("chip_smoke: check failed"):
                raise
            failed.append(f"{name}: {e}")
            emit("parallel_failed", path=name, error=str(e), device=dev_name)

    def hold_world(name):
        row = {"world": p, "backend": backend, "seconds": outs[0]["seconds"][name]}
        ranks = [o["results"][name] for o in outs]
        if name == "cholesky":
            row["launches"] = launches_held(name)
            row["results"] = ranks[0]
            emit("parallel", path=name, **row, device=dev_name)
            return
        one, one_l, row["one_device_seconds"] = world_one_device(name, p, dev, torch.float32, spec)
        ref, _, row["f64_seconds"] = world_one_device(name, p, world_f64_device(name, dev), torch.float64, spec)
        row["launches"] = launches_held(name)
        ranks64 = None
        if name in WORLD_F64_ON_CARD:
            ranks64 = [o["results"][f"{name}_f64"] for o in outs]
            row.update(f64_rank_seconds=outs[0]["seconds"][f"{name}_f64"], f64_launches=launches_held(f"{name}_f64"))
        if name in ("gibbs_sparse", "marginals"):
            check(one_l["gibbs_gram"] >= (4 if name == "gibbs_sparse" else 1),
                  f"world {p} {name}: K9 on one device ({one_l['gibbs_gram']})")
        if name == "sharded_cg":
            row["comm"] = {**outs[0]["results"]["comm"], "launches": launches_held("comm")}
        try:
            row.update(hold_path(f"world {p} {name}", name, p, ranks, one, ref, ranks64))
            if name == "fit_splits" and p > 1:
                row["batch_probe"] = fit_splits_batch_probe(p, dev, ranks[0])
        finally:
            emit("parallel", path=name, **row, device=dev_name)

    for name in WORLD_PATHS:
        guarded(name, lambda: hold_world(name))

    from nonstationary_precip_tpu_torch.examples import quickstart_dataparallel, quickstart_sharded_largen  # noqa: F401

    rows = {}

    def hold_quickstart(q):
        name = f"quickstart_{q}"
        res = outs[0]["results"][name]
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        one = w_quickstart(q, 1)
        torch.cuda.synchronize()
        rows[q] = {"seconds": outs[0]["seconds"][name], "one_device_seconds": time.perf_counter() - t1,
                   "printed": res["printed"][-4:], "one_device_printed": one["printed"][-4:],
                   **{k: v for k, v in res.items() if k not in ("printed",) and not isinstance(v, list)}}
        check(res["printed"][-1:] == ["ok"], f"world {p} {q} ends with ok: {res['printed'][-3:]}")
        for r in range(1, p):
            check("ok" not in outs[r]["results"][name]["printed"], f"world {p} {q}: only rank 0 prints")
        check(res.get("world") == p, f"world {p} {q} ran on {res.get('world')} ranks")
        rows[q]["launches"] = launches_held(name)

    with world1(dev):
        for q in WORLD_QUICKSTARTS:
            guarded(f"quickstart_{q}", lambda: hold_quickstart(q))
    emit("parallel_examples", world=p, rows=rows, device=dev_name)
    emit("kernels", world=p, launches=[_nonzero(t) for t in totals], ranks_seconds=ranks_s,
         rank_seconds={k: v for k, v in outs[0]["seconds"].items()})
    check(not failed, f"world {p}: {len(failed)} path(s) failed: " + " | ".join(failed))
    return totals


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--steps", type=int, default=300, help="Adam steps of the slice run")
    ap.add_argument("--world", type=int, default=0,
                    help="run parallel/ on this many cards of the host over NCCL, one spawned rank a card, "
                         "instead of the one-card smoke (raises where the host has fewer cards)")
    ap.add_argument("--octave", type=int, default=0,
                    help="run the JAX package's flagship configuration at this many rows instead of the smoke: "
                         "(i) its recorded prior-free run, (ii) the serve CLI's flagship with its prior")
    args = ap.parse_args(argv)

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: CUDA is not available; this smoke test runs only on a CUDA card")
    if args.world:
        return main_world(args.world)
    if args.octave:
        return main_octave(args.octave)
    name = torch.cuda.get_device_name(0)
    smi = nvidia_smi_line()
    emit("device", kind=name, count=torch.cuda.device_count(), nvidia_smi=smi, torch=torch.__version__,
         cuda=torch.version.cuda)

    from nonstationary_precip_tpu_torch.examples import quickstart_gibbs_chunked as quickstart_chunked
    from nonstationary_precip_tpu_torch.examples import quickstart_cg_largen as quickstart_cg
    from nonstationary_precip_tpu_torch.examples import quickstart_gibbs_largen as quickstart
    from nonstationary_precip_tpu_torch.experiments import precipitation_baselines as pb
    from nonstationary_precip_tpu_torch.experiments import (deepgp_spatial, exact_largen, field_regression,
                                                            gibbs_largen, seard_spatial, sgpr_bench, spatial_gibbs,
                                                            spatio_temporal, spatiotemporal_dgp,
                                                            spatiotemporal_stationary, temporal)
    from nonstationary_precip_tpu_torch.ops import (chol_blocked, chol_inv, chol_stream, elbo_fused, gibbs_fused,
                                                    gibbs_gram, matvec, svgp_precompute, trsm)
    from nonstationary_precip_tpu_torch import __main__ as cli
    from nonstationary_precip_tpu_torch import serve
    from nonstationary_precip_tpu_torch.utils import config

    dev = config.device("cuda")
    logs = build_all(chol_inv, matvec, svgp_precompute, chol_stream, elbo_fused, gibbs_gram, chol_blocked, trsm,
                     gibbs_fused)

    errs, ms, plain_ms, k1_design = phase_k1(chol_inv, spatial_gibbs, dev)
    launches, slice_k9 = phase_slice(chol_inv, spatial_gibbs, args.steps, name)
    phase_largen_ref(gibbs_largen)
    out, largen_launches = phase_largen(gibbs_largen, name)
    payloads = largen_payloads(gibbs_largen, out, dev)
    k2_errs, k2_t, k2_bound, k2_by, k2_call = phase_k2(matvec, payloads, dev)
    k3_errs, k3_t, k3_bound, k3_by, k3_call = phase_k3(matvec, payloads, dev)
    k2_modes = phase_k2_modes(gibbs_largen, matvec, payloads, out, dev)
    phase_dgp_ref(deepgp_spatial, svgp_precompute, dev)
    dgp_out, dgp_launches = phase_dgp(deepgp_spatial, svgp_precompute, name)
    k4_errs, k4_t, k4_bound, k4_by, k4_design, k4_call = phase_k4(deepgp_spatial, svgp_precompute,
                                                                  dgp_out["model"], dev)
    k10b = phase_k10b(chol_inv, svgp_precompute, spatial_gibbs, dgp_out["model"], dev)
    k7 = phase_k7(deepgp_spatial, elbo_fused, dgp_out["model"], dev)
    k7_smem = elbo_fused.dynamic_smem()
    phase_field_regression(field_regression, name)
    k5 = phase_k5(chol_stream, exact_largen, dev)
    k5["resources"] = rl_resources(chol_stream.kernel_attributes(), logs["chol_stream"])
    k10c = phase_k10c(chol_stream, exact_largen, dev)
    k10c["resources"] = rl_resources(chol_stream.kernel_attributes_v1(), logs["chol_stream_v1"])
    k5_launches = phase_exact_dense(exact_largen, chol_stream, name)
    phase_seard_ref(seard_spatial, dev)
    phase_seard(seard_spatial, name)
    phase_temporal(temporal, name)
    phase_exact_lazy_ref(exact_largen)
    lazy_out, k6_launches = phase_exact_lazy(exact_largen, name)
    k6 = phase_k6(matvec, exact_largen, lazy_out, dev)
    k6_modes = phase_k6_modes(exact_largen, matvec, lazy_out, dev)
    phase_gibbs_dense_ref(exact_largen, dev)
    gibbs_out, gibbs_launches = phase_gibbs_dense(exact_largen, name)
    gibbs_pay = gibbs_payloads(exact_largen, gibbs_out, dev)
    k9 = phase_k9(gibbs_gram, matvec, spatial_gibbs, gibbs_pay, dev, k9_stack_payloads(spatial_gibbs, spatio_temporal,
                                                                                     dev))
    k10a = phase_k10a(chol_blocked, gibbs_pay, dev)
    k10a["resources"] = rl_resources(chol_blocked.kernel_attributes(), logs["chol_blocked"])
    k11 = phase_k11(trsm, gibbs_pay, dev)
    k11["resources"] = rl_resources(trsm.kernel_attributes(), logs["trsm"])
    k8 = phase_k8(gibbs_fused, gibbs_pay, dev)
    k8["resources"] = rl_resources(gibbs_fused.kernel_attributes(), logs["gibbs_fused"])
    traced = phase_traced(chol_inv, k1_design.pop("gram"), k2_call, k3_call, k4_call, k6.pop("call"),
                          k7.pop("fwd_call"), k7.pop("bwd_call"), k9.pop("call"), k10b.pop("call"),
                          k9.pop("stacked_call"))
    k9.update(device_ms=traced["k9_device_ms"],
              resources={"gibbs_gram_kernel<2,4>": ptxas_resources(logs["gibbs_gram"], "gibbs_gram_kernel<2,4>")})
    k12 = phase_k12(matvec, quickstart, dev)
    mf_ref_launches = phase_gibbs_mf_ref(quickstart, dev)
    mf_launches = phase_gibbs_mf(quickstart, name)
    timed = {}
    for phase, run in (("sparse_ref", lambda: phase_sparse_ref(spatial_gibbs, spatio_temporal, sgpr_bench, dev)),
                       ("gibbs_sparse", lambda: phase_gibbs_sparse(spatial_gibbs, name)),
                       ("spatio_temporal", lambda: phase_spatio_temporal(spatiotemporal_stationary, spatio_temporal,
                                                                         name)),
                       ("sgpr", lambda: phase_sgpr(sgpr_bench, chol_blocked, dev, name)),
                       ("st_dgp", lambda: phase_st_dgp(spatiotemporal_dgp, svgp_precompute, dev, name)),
                       ("serve_ref", lambda: phase_serve_ref(serve, dev)),
                       ("serve", lambda: phase_serve(serve, cli, name)),
                       ("chunked_ref", lambda: phase_chunked_ref(quickstart_chunked, dev)),
                       ("chunked", lambda: phase_chunked(serve, quickstart_chunked, dev, name)),
                       ("baselines_ref", lambda: phase_baselines_ref(pb)),
                       ("baselines", lambda: phase_baselines(pb, name)),
                       ("baselines_dense", lambda: phase_baselines_dense(pb, gibbs_fused, dev, name)),
                       ("full_cov", lambda: phase_full_cov(deepgp_spatial, svgp_precompute, dev, name)),
                       ("dense_cg", lambda: phase_dense_cg(quickstart_cg, dev, name)),
                       ("quickstarts", lambda: phase_quickstarts(name)),
                       ("parallel", lambda: phase_parallel(out, dev, name)),
                       ("k2_rows", lambda: phase_k2_rows(matvec, payloads, dev)),
                       ("parallel_examples", lambda: phase_parallel_examples(dev, name))):
        t0 = time.perf_counter()
        timed[phase] = run()
        emit("seconds", of=phase, seconds=time.perf_counter() - t0)
    served = {k: timed["serve_ref"].get(k, 0) + timed["serve"].get(k, 0) + timed["chunked_ref"].get(k, 0)
              + timed["chunked"].get(k, 0)
              for k in ("gibbs_gram", "svgp_precompute", "elbo_data_term_fwd", "elbo_data_term_bwd", "gibbs_matvec",
                        "gibbs_panel_grads", "se_matvec_f64")}
    # the driver's, the quickstarts' and full_cov's launches
    driven = {k: timed["baselines_ref"].get(k, 0) + timed["baselines"].get(k, 0) + timed["baselines_dense"][0].get(k, 0)
              + timed["quickstarts"].get(k, 0)
              for k in ("gibbs_gram", "svgp_precompute", "elbo_data_term_fwd", "elbo_data_term_bwd", "rbf_matvec",
                        "gibbs_chol_solve_fused", "blocked_cholesky", "blocked_trsm")}
    # the parallel paths' and their examples' launches (world 1 on NCCL)
    par = {k: timed["parallel"].get(k, 0) + timed["parallel_examples"].get(k, 0)
           for k in ("chol_inv_batched", "gibbs_matvec", "svgp_precompute", "elbo_data_term_fwd",
                     "elbo_data_term_bwd", "gibbs_gram", "blocked_cholesky", "blocked_trsm")}
    driven = {k: v + par.get(k, 0) for k, v in driven.items()}
    k9_launches = (gibbs_launches["gibbs_gram"] + slice_k9 + timed["gibbs_sparse"] + timed["spatio_temporal"]
                   + served["gibbs_gram"] + driven["gibbs_gram"])
    k4_launches = (dgp_launches["svgp_precompute"] + timed["st_dgp"][0] + served["svgp_precompute"]
                   + driven["svgp_precompute"] + timed["full_cov"])
    k4_errs.update(timed["st_dgp"][1])
    k10a_launches = gibbs_launches["blocked_cholesky"] + timed["sgpr"][0] + driven["blocked_cholesky"]
    k10a["max_abs_err"] = max(k10a["max_abs_err"], timed["sgpr"][1]["max_abs_err"])
    k8_dense = timed["baselines_dense"][1]
    k8["max_abs_err"] = max(k8["max_abs_err"], k8_dense["L"]["max_abs_err"], k8_dense["alpha"]["max_abs_err"])

    # K1 at (10, 316): 2N³/3 flops per matrix (Cholesky and triangular
    # inverse, N³/3 each); reads A once, writes L and L⁻¹
    k1_bound, k1_by = bound(10 * 2 * 316**3 / 3, 4 * 3 * 10 * 316 * 316)
    print(nvidia_smi_line(), flush=True)
    print(json.dumps({"kernels": [
        {"name": "chol_inv_batched_safe", "route": "cuda",
         "source": "nonstationary_precip_tpu_torch/csrc/chol_inv_cluster.cu",
         "replaces": "nonstationary_precip_tpu/ops/pallas_chol.py:1054", "launches": launches + par["chol_inv_batched"],
         "max_abs_err": errs["gibbs_gram"]["max_abs_err"], "ms": ms, "plain_ms": plain_ms,
         "bound_ms": k1_bound, "bound_by": k1_by, "library_ms": None,
         "resources": {"chol_inv_cluster_kernel": {**ptxas_resources(logs["chol_inv"], "chol_inv_cluster_kernel"),
                                                   **k1_design}}},
        {"name": "gibbs_matvec", "route": "cuda", "source": "nonstationary_precip_tpu_torch/csrc/gibbs_matvec.cu",
         "replaces": "nonstationary_precip_tpu/ops/pallas_matvec.py:240",
         "launches": (largen_launches["gibbs_matvec"] + mf_launches["gibbs_matvec"] + served["gibbs_matvec"]
                      + par["gibbs_matvec"]),
         "max_abs_err": max(e["max_abs_err"] for e in (*k2_errs.values(), *timed["k2_rows"]["errors"].values())),
         "ms": k2_t["ms"],
         "plain_ms": k2_t["plain_ms"], "bound_ms": k2_bound, "bound_by": k2_by, "library_ms": None,
         "resources": {WALK["K2"]: ptxas_resources(logs["gibbs_matvec"], WALK["K2"])}},
        {"name": "gibbs_panel_grads", "route": "cuda",
         "source": "nonstationary_precip_tpu_torch/csrc/gibbs_matvec.cu",
         "replaces": "nonstationary_precip_tpu/ops/pallas_matvec.py:350",
         "launches": (largen_launches["gibbs_panel_grads"] + mf_launches["gibbs_panel_grads"]
                      + served["gibbs_panel_grads"]),
         "max_abs_err": max(e["max_abs_err"] for e in k3_errs.values()), "ms": k3_t["ms"],
         "plain_ms": k3_t["plain_ms"], "bound_ms": k3_bound, "bound_by": k3_by, "library_ms": None,
         "resources": {WALK["K3"]: ptxas_resources(logs["gibbs_matvec"], WALK["K3"])}},
        {"name": "svgp_precompute", "route": "cuda",
         "source": "nonstationary_precip_tpu_torch/csrc/svgp_precompute.cu",
         "replaces": "nonstationary_precip_tpu/ops/pallas_svgp.py:367", "launches": k4_launches,
         "max_abs_err": max(e["max_abs_err"] for e in k4_errs.values()), "ms": k4_t["ms"],
         "plain_ms": k4_t["plain_ms"], "bound_ms": k4_bound, "bound_by": k4_by, "library_ms": None,
         "resources": {"svgp_cluster_kernel": {**ptxas_resources(logs["svgp_precompute"], "svgp_cluster_kernel"),
                                               "cluster": k4_design["cluster"],
                                               "smem_bytes": k4_design["smem_bytes"]}}},
        *({"name": f"elbo_data_term_{d}", "route": "cuda",
           "source": "nonstationary_precip_tpu_torch/csrc/elbo_fused.cu",
           "replaces": f"nonstationary_precip_tpu/ops/pallas_elbo.py:{line}",
           "launches": (dgp_launches[f"elbo_data_term_{d}"] + served[f"elbo_data_term_{d}"]
                        + driven[f"elbo_data_term_{d}"]),
           "max_abs_err": k7[d]["max_abs_err"], "ms": k7[d]["ms"],
           "plain_ms": k7[d]["plain_ms"], "bound_ms": k7[d]["bound"][0], "bound_by": k7[d]["bound"][1],
           "library_ms": None, "resources": {k: {**ptxas_resources(logs["elbo_fused"], k),
                                                 "smem_bytes": k7_smem.get(k, 0) + ptxas_smem(logs["elbo_fused"], k)}
                                             for k in kernels}}
          for d, line, kernels in (("fwd", 282, K7_FWD_KERNELS), ("bwd", 331, K7_BWD_KERNELS))),
        {"name": "streaming_cholesky", "route": "cuda",
         "source": "nonstationary_precip_tpu_torch/csrc/chol_stream.cu",
         "replaces": "nonstationary_precip_tpu/ops/pallas_chol.py:818", "launches": k5_launches,
         "max_abs_err": k5["max_abs_err"], "ms": k5["ms"], "plain_ms": k5["plain_ms"], "bound_ms": k5["bound_ms"],
         "bound_by": k5["bound_by"], "library_ms": k5["library_ms"], "resources": k5["resources"]},
        *({"name": f"{kname}_{mode}", "route": "cuda", "source": "nonstationary_precip_tpu_torch/csrc/gibbs_matvec.cu",
           "replaces": f"nonstationary_precip_tpu/ops/pallas_matvec.py:{line}", "launches": k[mode]["launches"],
           "max_abs_err": max(e["max_abs_err"] for e in k[mode]["errs"]), "ms": k[mode]["t"]["ms"],
           "plain_ms": k[mode]["t"]["plain_ms"], "bound_ms": k[mode]["bound"][0], "bound_by": k[mode]["bound"][1],
           "library_ms": None,
           "resources": {MMA_WALK[kname]: ptxas_resources(logs["gibbs_matvec"], MMA_WALK[kname])}}
          for kname, line, k in (("gibbs_matvec", 207, k2_modes), ("rbf_matvec", 493, k6_modes))
          for mode in ("default", "high3")),
        {"name": "rbf_matvec", "route": "cuda", "source": "nonstationary_precip_tpu_torch/csrc/gibbs_matvec.cu",
         "replaces": "nonstationary_precip_tpu/ops/pallas_matvec.py:527",
         "launches": k6_launches + driven["rbf_matvec"],
         "max_abs_err": k6["max_abs_err"], "ms": k6["ms"], "plain_ms": k6["plain_ms"], "bound_ms": k6["bound_ms"],
         "bound_by": k6["bound_by"], "library_ms": None,
         "resources": {WALK["K6"]: ptxas_resources(logs["gibbs_matvec"], WALK["K6"])}},
        *({"name": kname, "route": "cuda", "source": f"nonstationary_precip_tpu_torch/csrc/{src}",
           "replaces": f"nonstationary_precip_tpu/ops/{tpu}",
           "launches": {"gibbs_gram": k9_launches, "blocked_cholesky": k10a_launches}.get(
               kname, gibbs_launches[kname] + driven[kname]),
           "max_abs_err": k["max_abs_err"], "ms": k["ms"], "plain_ms": k["plain_ms"], "bound_ms": k["bound_ms"],
           "bound_by": k["bound_by"], "library_ms": k.get("library_ms"),
           **{key: k[key] for key in ("device_ms", "resources") if key in k}}
          for kname, src, tpu, k in (("gibbs_chol_solve_fused", "gibbs_fused.cu", "pallas_fused.py:276", k8),
                                     ("gibbs_gram", "gibbs_gram.cu", "pallas_gram.py:136", k9),
                                     ("blocked_cholesky", "chol_blocked.cu", "pallas_chol.py:251", k10a),
                                     ("blocked_trsm", "trsm.cu", "pallas_trsm.py:106", k11))),
        {"name": "se_matvec_f64", "route": "cuda", "source": "nonstationary_precip_tpu_torch/csrc/se_matvec_f64.cu",
         "replaces": "nonstationary_precip_tpu/priors/lognormal_process.py:263",
         "launches": mf_ref_launches["se_matvec_f64"] + mf_launches["se_matvec_f64"] + served["se_matvec_f64"],
         "max_abs_err": k12["max_abs_err"], "ms": k12["ms"], "plain_ms": k12["plain_ms"], "bound_ms": k12["bound_ms"],
         "bound_by": k12["bound_by"], "library_ms": None,
         "resources": {w: ptxas_resources(logs["se_matvec_f64"], w) for w in K12_WALK}},
        *({"name": kname, "route": "cuda", "source": f"nonstationary_precip_tpu_torch/csrc/{src}",
           "replaces": f"nonstationary_precip_tpu/ops/{tpu}", "launches": k["launches"],
           "max_abs_err": k["max_abs_err"], "ms": k["ms"], "plain_ms": k["plain_ms"], "bound_ms": k["bound_ms"],
           "bound_by": k["bound_by"], "library_ms": k.get("library_ms"),
           **({"resources": k["resources"]} if "resources" in k else {})}
          for kname, src, tpu, k in (("chol_inv_grid", "chol_inv_cluster.cu", "pallas_chol.py:348", k10b),
                                     ("streaming_cholesky_v1", "chol_stream_v1.cu", "pallas_chol.py:601", k10c))),
    ]}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}),
          flush=True)


def world_fail(mode: str) -> int:
    """Rank 0 enters an all-reduce that rank 1 never joins: rank 1 raises
    (``mode`` "raise", a rank that fails) or sleeps past every timeout
    ("hang", a rank that never arrives)."""
    from nonstationary_precip_tpu_torch.parallel import make_mesh
    from nonstationary_precip_tpu_torch.parallel.collectives import psum

    mesh = make_mesh()
    if mesh.rank == 0:
        psum(torch.ones(3, device=mesh.device), mesh)
        if mesh.device.type == "cuda":
            torch.cuda.synchronize()
    elif mode == "raise":
        raise RuntimeError("world_fail: rank 1 fails on purpose")
    else:
        time.sleep(600)
    return mesh.rank


WORLD_FAIL_DEADLINE, WORLD_FAIL_TIMEOUT = 45.0, 10.0  # seconds: the spawn's deadline, the group's timeout


def phase_world_failure(dev_name: str, device: str = "cuda"):
    """On 2 ranks over NCCL, a rank that raises and a rank that hangs
    (``world_fail``): each run must raise within the spawn's deadline, every
    rank killed, with no hang in NCCL's watchdog."""
    from datetime import timedelta

    from nonstationary_precip_tpu_torch.parallel.launch import start

    rows = {}
    for mode in ("raise", "hang"):
        t0 = time.perf_counter()
        group = start("chip_smoke:world_fail", 2, device=device, args=(mode,), deadline=WORLD_FAIL_DEADLINE,
                      group_timeout=timedelta(seconds=WORLD_FAIL_TIMEOUT), echo=False,
                      paths=[Path(__file__).resolve().parent])
        try:
            group.join()
            raised = None
        except (RuntimeError, TimeoutError) as e:
            raised = f"{type(e).__name__}: {str(e).splitlines()[0]}"
        wall = time.perf_counter() - t0
        alive = [r for r, q in enumerate(group.procs) if q.poll() is None]
        check(raised is not None and wall <= WORLD_FAIL_DEADLINE + 15 and not alive,
              f"world_fail {mode}: raised {raised!r} in {wall:.1f} s, ranks alive {alive}")
        rows[mode] = {"raised": raised, "seconds": wall}
    emit("failure", rows=rows, deadline=WORLD_FAIL_DEADLINE, group_timeout=WORLD_FAIL_TIMEOUT, device=dev_name)


def main_world(p: int):
    """``--world P``: every kernel built here once (the ranks load the same
    libraries from build/torch_kernels/), the gate's trained pose made on
    card 0 (``gibbs_largen.run``, as the one-card ``largen`` phase makes
    it), then ``phase_world``.  A host with fewer than P cards raises
    before anything runs: a smaller world would hold nothing of P's."""
    count = torch.cuda.device_count()
    if p < 1 or count < p:
        raise SystemExit(f"chip_smoke --world {p}: needs {p} cards, this host has {count}")
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True).stdout.strip().splitlines()
    emit("device", kind=name, count=count, world=p, nvidia_smi=smi[0], nvidia_smi_cards=smi, torch=torch.__version__,
         cuda=torch.version.cuda)

    from nonstationary_precip_tpu_torch.experiments import gibbs_largen
    from nonstationary_precip_tpu_torch.ops import (chol_blocked, chol_inv, chol_stream, elbo_fused, gibbs_fused,
                                                    gibbs_gram, matvec, svgp_precompute, trsm)
    from nonstationary_precip_tpu_torch.utils import config

    dev = config.device("cuda")
    build_all(chol_inv, matvec, svgp_precompute, chol_stream, elbo_fused, gibbs_gram, chol_blocked, trsm, gibbs_fused)
    t0 = time.perf_counter()
    out = gibbs_largen.run(gibbs_largen.LargeNConfig(n=LARGEN_N, device="cuda"))
    spec = gate_spec(out)
    emit("gate_pose", n=LARGEN_N, relres_solve=out["relres_solve"], seconds=time.perf_counter() - t0)
    del out
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    phase_world(p, dev, name, spec)
    emit("seconds", of="world", seconds=time.perf_counter() - t0)
    if p >= 2:
        phase_world_failure(name)
    print(nvidia_smi_line(), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}),
          flush=True)


# --octave N: the JAX package's N = 1,048,576 flagship and its recorded
# configuration (tools/probe_chunked.py, whose row in tools/bench_cg.json is
# chunked-lazygnys-r1024-i32x8-s10-1048576): x ~ U[−3, 3]² and
# y = sin 2x₀ · cos x₁ + 0.1ε from default_rng(0); the unscaled Gibbs
# MLL, host-chunked (4-iteration chunks, 8 of them, tol 1e-6) with the keyed
# Nyström factor of rank 1024 at shift 10, block 2048, 8 probes; Adam at lr
# 1e-2 from log ℓ = 0, log σ² = −2; then the chunked mean-only state (16
# chunks, the shift ladder 10, 100, 1000 until its α relres is within the
# gate) and 2048 held-out points from default_rng(100), the trained field
# carried to them by nearest neighbour.
OCTAVE_STEPS, OCTAVE_RANK, OCTAVE_SHIFTS, OCTAVE_CHUNK, OCTAVE_CHUNKS = 3, 1024, (10.0, 100.0, 1000.0), 4, 8
OCTAVE_HELDOUT, OCTAVE_POINTS, OCTAVE_PROBES = 2048, 128, 8
OCTAVE_JAX_ROW = "chunked-lazygnys-r1024-i32x8-s10-1048576"


def octave_data(n: int, dev):
    """tools/probe_chunked.py's training data at n rows, float32 on ``dev``."""
    rng = np.random.default_rng(0)
    x = torch.tensor(rng.uniform(-3, 3, size=(n, 2)), dtype=torch.float32, device=dev)
    eps = torch.tensor(rng.normal(size=n), dtype=torch.float32, device=dev)
    return x, torch.sin(2 * x[:, 0]) * torch.cos(x[:, 1]) + 0.1 * eps


def octave_heldout(dev):
    """The held-out points (default_rng(100)) and the generating function there."""
    xt = torch.tensor(np.random.default_rng(100).uniform(-3, 3, size=(OCTAVE_HELDOUT, 2)), dtype=torch.float32,
                      device=dev)
    return xt, torch.sin(2 * xt[:, 0]) * torch.cos(xt[:, 1])


def nn_field(x, log_ell, xt, chunk: int = 256):
    """The trained field at xt by nearest neighbour, in (chunk, N) distance
    blocks from the matmul expansion (probe_chunked.py's ``_nn_field``)."""
    sq = torch.sum(x * x, dim=1)
    idx = [torch.argmin(torch.sum(b * b, dim=1)[:, None] + sq[None, :] - 2.0 * (b @ x.T), dim=1)
           for b in xt.split(chunk)]
    return log_ell[torch.cat(idx)]


def octave_jax_config(n: int, dev) -> dict:
    """(i): the recorded configuration at n rows, prior-free, on K2 and K3:
    OCTAVE_STEPS Adam steps, each step's loss, relres and iterations, every
    training solve within serve.RELRES_GATE; the Nyström directions kept at
    the trained pose; the state's α relres at each shift tried; the
    held-out RMSE against the generating function and the predict-zero
    baseline's.  K2 once an iteration, K3 once a step, no other kernel."""
    from nonstationary_precip_tpu_torch import serve
    from nonstationary_precip_tpu_torch.kernels.gibbs import packed_gibbs_cross
    from nonstationary_precip_tpu_torch.ops import matvec
    from nonstationary_precip_tpu_torch.ops.lazy_cg import (build_precond_factor, lazy_posterior_query,
                                                            lazy_posterior_state_chunked, make_chunked_mll)

    x, y = octave_data(n, dev)
    cross = packed_gibbs_cross(2)
    mll = make_chunked_mll(2048, OCTAVE_CHUNK, OCTAVE_CHUNKS, 1e-6, OCTAVE_RANK, "nystrom", 10.0, cross,
                           matvec.packed_gibbs_matvec_builder(2), matvec.packed_gibbs_panel_vjp(2))
    rng = np.random.default_rng(5)
    probes = tuple(torch.tensor(rng.standard_normal(shape), dtype=torch.float32, device=dev)
                   for shape in ((OCTAVE_RANK, OCTAVE_PROBES), (n, OCTAVE_PROBES)))

    def landmarks():  # JAX's fixed key: the same keyed landmarks every call
        return torch.Generator().manual_seed(17)

    log_ell = torch.zeros((n, 2), dtype=torch.float32, device=dev, requires_grad=True)
    log_noise = torch.tensor(-2.0, device=dev, requires_grad=True)
    opt = torch.optim.Adam([log_ell, log_noise], lr=1e-2, betas=(0.9, 0.999), eps=1e-8)
    steps = []
    for i in range(OCTAVE_STEPS):
        reset_launches()
        t0 = time.perf_counter()
        aug = torch.cat([x, log_ell.detach()], dim=1)
        val, relres, (_, xg, _, s2g) = mll.value_and_grad(None, aug, y, torch.exp(log_noise.detach()), probes,
                                                          pkey=landmarks())
        log_ell.grad, log_noise.grad = -xg[:, 2:] / n, -s2g * torch.exp(log_noise.detach()) / n
        opt.step()
        torch.cuda.synchronize()
        got = check_launches({"gibbs_matvec": mll.iters, "gibbs_panel_grads": 1}, f"octave {n} step {i}")
        steps.append({"loss": -float(val) / n, "relres_max": float(relres.max()), "iters": mll.iters,
                      "seconds": time.perf_counter() - t0, "launches": _nonzero(got)})
        emit("octave_step", n=n, step=i, **steps[-1])
        check(np.isfinite(steps[-1]["loss"]) and steps[-1]["relres_max"] <= serve.RELRES_GATE,
              f"octave {n} step {i}: finite, training relres {steps[-1]['relres_max']:.3g} <= {serve.RELRES_GATE}")
    check(bool(torch.isfinite(log_ell).all()) and bool(torch.isfinite(log_noise)), f"octave {n}: finite pose")
    aug = torch.cat([x, log_ell.detach()], dim=1)
    s2 = torch.exp(log_noise.detach())
    lpc = build_precond_factor("nystrom", None, aug, OCTAVE_RANK, cross, landmarks())
    kept = int((lpc.abs().amax(0) > 0).sum())
    del lpc
    reset_launches()
    ladder, state = [], None
    t0 = time.perf_counter()
    for shift in OCTAVE_SHIFTS:
        st = lazy_posterior_state_chunked(None, aug, y, s2, block=2048, chunk_iters=OCTAVE_CHUNK,
                                          n_chunks=2 * OCTAVE_CHUNKS, tol=1e-6, precond_rank=OCTAVE_RANK,
                                          precond="nystrom", precond_key=landmarks(), precond_shift=shift,
                                          cross_fn=cross, matvec_builder=matvec.packed_gibbs_matvec_builder(2))
        ladder.append({"shift": shift, "alpha_relres": float(st.alpha_relres), "iters": st.iters})
        emit("octave_state", n=n, **ladder[-1])
        if state is None or ladder[-1]["alpha_relres"] < min(r["alpha_relres"] for r in ladder[:-1]):
            state = st
        if ladder[-1]["alpha_relres"] <= serve.RELRES_GATE:
            break
    state_s = time.perf_counter() - t0
    check_launches({"gibbs_matvec": sum(r["iters"] for r in ladder)}, f"octave {n} state")
    xt, truth = octave_heldout(dev)
    aug_t = torch.cat([xt, nn_field(x, log_ell.detach(), xt)], dim=1)
    mean = torch.cat([lazy_posterior_query(state, a, mean_only=True, cross_fn=cross)[0] for a in aug_t.split(256)])
    rmse, base = float(torch.sqrt(torch.mean((mean - truth) ** 2))), float(torch.sqrt(torch.mean(truth ** 2)))
    check(np.isfinite(rmse) and bool(torch.isfinite(state.alpha).all()), f"octave {n}: finite state and RMSE")
    out = {"n": n, "steps": steps, "kept_directions": kept, "rank": OCTAVE_RANK, "state_ladder": ladder,
           "state_seconds": state_s, "heldout_rmse": rmse, "baseline_rmse": base,
           "log_noise": float(log_noise.detach())}
    jax_row = Path(__file__).resolve().parent / "tools" / "bench_cg.json"
    if jax_row.exists():
        row = json.loads(jax_row.read_text()).get(OCTAVE_JAX_ROW, {})
        out["jax_reading"] = {k: row.get(k) for k in ("relres_max_final", "heldout_rmse", "heldout_baseline_rmse",
                                                       "state_alpha_relres", "chunk_iters", "n_chunks")}
    emit("octave_jax", **out)
    return out


def octave_serve(n: int, steps: int, dev) -> dict:
    """(ii): ``serve --model gibbs_exact --matrixfree true --chunked true
    --precond nystrom --precond_rank 1024 --precond_shift 10`` on the n-row
    CSV of ``octave_data`` with OCTAVE_POINTS held-out query points
    (variances served): the hoist's, the fit's and the serve's seconds,
    every solve's relres and iterations, the launches (K2 once an iteration
    of each data solve, K3 once a step, K12 once a prior iteration and once
    a dim a query chunk), every training solve within serve.RELRES_GATE, a
    finite mean and std, and no panel built on the card (``lazy_cg._panel``
    and K12's plain version never called)."""
    from nonstationary_precip_tpu_torch import serve
    from nonstationary_precip_tpu_torch.ops import lazy_cg, matvec

    x, y = octave_data(n, dev)
    plain_calls = {"panel": 0, "k12_plain": 0}

    def counted(fn, key):
        def wrapped(*a, **k):
            plain_calls[key] += 1
            return fn(*a, **k)
        return wrapped

    with tempfile.TemporaryDirectory() as tmp:
        train, pts = os.path.join(tmp, "train.csv"), os.path.join(tmp, "pts.csv")
        t0 = time.perf_counter()
        np.savetxt(train, np.column_stack([x.cpu().numpy(), y.cpu().numpy()]), delimiter=",", header="x0,x1,y",
                   comments="", fmt="%.9g")
        np.savetxt(pts, octave_heldout(dev)[0][:OCTAVE_POINTS].cpu().numpy(), delimiter=",", header="x0,x1",
                   comments="", fmt="%.9g")
        csv_s = time.perf_counter() - t0
        del x, y
        argv = ["--model", "gibbs_exact", "--matrixfree", "true", "--chunked", "true", "--precond", "nystrom",
                "--precond_rank", str(OCTAVE_RANK), "--precond_shift", "10", "--train_csv", train, "--points_csv", pts,
                "--max_iters", str(steps), "--device", "cuda", "--output", os.path.join(tmp, "p.csv")]
        panel, k12_plain = lazy_cg._panel, matvec.se_f64_matvec_plain
        lazy_cg._panel, matvec.se_f64_matvec_plain = counted(panel, "panel"), counted(k12_plain, "k12_plain")
        try:
            torch.cuda.reset_peak_memory_stats()
            reset_launches()
            t0 = time.perf_counter()
            run = serve.run(serve.config(argv))
            wall = time.perf_counter() - t0
        finally:
            lazy_cg._panel, matvec.se_f64_matvec_plain = panel, k12_plain
    queries = run["query_iters"]
    want = {"gibbs_matvec": int(sum(run["fit_iters"])) + run["alpha_iters"]
            + sum(q * -(-min(OCTAVE_POINTS, 1024) // matvec.MAX_R) for q in queries),
            "gibbs_panel_grads": run["executed"], "se_matvec_f64": serve_prior_launches(run)}
    launches = check_launches(want, f"octave serve {n}")
    check(plain_calls == {"panel": 0, "k12_plain": 0}, f"octave serve {n}: no panel built on the card {plain_calls}")
    check(bool(np.isfinite(run["mean"]).all() and np.isfinite(run["std"]).all()), f"octave serve {n}: finite")
    check(bool((run["fit_relres"] <= serve.RELRES_GATE).all()),
          f"octave serve {n}: training solves' relres {run['fit_relres'].tolist()} <= {serve.RELRES_GATE}")
    out = {"n": n, "steps": run["steps"], "losses": run["losses"].tolist(), "fit_relres": run["fit_relres"].tolist(),
           "fit_iters": run["fit_iters"].tolist(), "fit_prior_iters": run["fit_prior_iters"].tolist(),
           "fit_prior_relres": run["fit_prior_relres"].tolist(), "hoist_seconds": run["hoist_seconds"],
           "hoist_iters": run["hoist_iters"], "hoist_relres": run["hoist_relres"],
           "hoist_converged": [max(c) for c in run["hoist_converged"]], "fit_seconds": run["fit_seconds"],
           "serve_seconds": run["serve_seconds"], "wall_seconds": wall, "csv_seconds": csv_s,
           "alpha_relres": run["alpha_relres"], "alpha_iters": run["alpha_iters"],
           "prior_cond_relres": run["prior_relres"], "prior_cond_iters": run["prior_iters"],
           "worst_query_relres": run["worst_relres"], "query_iters": queries,
           "mean_range": [float(run["mean"].min()), float(run["mean"].max())],
           "std_range": [float(run["std"].min()), float(run["std"].max())],
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 2**30, "launches": _nonzero(launches)}
    emit("octave_serve", **out)
    return out


def main_octave(n: int):
    """``--octave N``: K2/K3 and K12 built (two nvcc runs at once), then (i)
    ``octave_jax_config`` and (ii) ``octave_serve`` at N rows, OCTAVE_STEPS
    steps each; the kernels' line (their launches, K12's bound at the octave's R = 1
    operator), nvidia-smi's line and the result line."""
    from nonstationary_precip_tpu_torch.ops import matvec

    name = torch.cuda.get_device_name(0)
    emit("device", kind=name, count=torch.cuda.device_count(), nvidia_smi=nvidia_smi_line(), torch=torch.__version__,
         cuda=torch.version.cuda, octave=n, steps=OCTAVE_STEPS)
    dev = torch.device("cuda")
    with ThreadPoolExecutor(2) as pool:
        logs = dict(zip(("gibbs_matvec", "se_matvec_f64"), pool.map(lambda b: b(force=True),
                                                                    (matvec.build, matvec.build_f64))))
    for lib, log in logs.items():
        emit("build", kernel=lib, ptxas=ptxas_summary(log))
    t0 = time.perf_counter()
    jax_out = octave_jax_config(n, dev)
    emit("seconds", of="octave_jax", seconds=time.perf_counter() - t0)
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    serve_out = octave_serve(n, OCTAVE_STEPS, dev)
    emit("seconds", of="octave_serve", seconds=time.perf_counter() - t0)
    launches = {k: sum(s["launches"].get(k, 0) for s in jax_out["steps"]) + serve_out["launches"].get(k, 0)
                for k in ("gibbs_matvec", "gibbs_panel_grads", "se_matvec_f64")}
    launches["gibbs_matvec"] += sum(r["iters"] for r in jax_out["state_ladder"])
    print(nvidia_smi_line(), flush=True)
    print(json.dumps({"kernels": [
        {"name": k, "route": "cuda", "source": f"nonstationary_precip_tpu_torch/csrc/{src}", "replaces": tpu,
         "launches": launches[k]}
        for k, src, tpu in (("gibbs_matvec", "gibbs_matvec.cu", "nonstationary_precip_tpu/ops/pallas_matvec.py:240"),
                            ("gibbs_panel_grads", "gibbs_matvec.cu",
                             "nonstationary_precip_tpu/ops/pallas_matvec.py:350"),
                            ("se_matvec_f64", "se_matvec_f64.cu",
                             "nonstationary_precip_tpu/priors/lognormal_process.py:263"))],
        "se_matvec_f64_bound_ms": matvec.se_f64_matvec_ops(n, n, 2, 1) / matvec.PEAK_F64 * 1e3}),
        flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}),
          flush=True)


if __name__ == "__main__":
    main()
