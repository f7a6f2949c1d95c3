"""nonstationary_precip_tpu_torch — the PyTorch/CUDA port of nonstationary_precip_tpu.

The JAX package beside it is the reference; this package keeps its module
paths and public names so each counterpart is found at the same place, and
never imports jax (nor the JAX package, whose config imports jax).

Layering (bottom-up), as far as the port reaches today:
  ops/      — dense linear algebra, mBCG/SLQ and the lazy MLL; wrappers of
              the hand-written CUDA kernels in ``csrc/``: ``chol_inv`` (K1,
              batched (L, L⁻¹)), ``matvec`` (K2/K3/K6, the Gibbs and RBF
              Gram·V and the Gibbs backward sweep), ``svgp_precompute`` (K4,
              the SVGP K_zz precompute), ``chol_stream`` (K5) and
              ``chol_blocked`` (K10a), the blocked Cholesky at two sizes,
              ``elbo_fused`` (K7, the DSVI data term), ``gibbs_fused`` (K8,
              the Gibbs MAP solve), ``gibbs_gram`` (K9) and ``trsm`` (K11);
              K1, K4 and K10b share one cluster schedule
              (``csrc/chol_inv_cluster.cuh``; K10b is K1's kernel with its
              retry off), K5, K8, K10a and K10c one right-looking
              factorisation (``csrc/chol_rl.cuh``), K2, K3 and K9 one d = 2
              Gibbs element (``csrc/gibbs_elem.cuh``)
  kernels/  — the Gibbs and squared-distance covariance functions
  priors/   — the log-normal latent-lengthscale process (dense part)
  models/   — Gaussian likelihood, DiagNormal/MVN, the Gibbs exact GP (MAP),
              the whitened SVGP layer and the DSVI deep GP
  train/    — Adam loops (full-batch and epoch-shuffled minibatch), the
              split-batched trainer, metrics, config
  data/     — numpy CSV loaders, transforms and the seeded split harnesses
  interop   — carries JAX model weights into the port's modules
"""

__version__ = "0.1.0"

from nonstationary_precip_tpu_torch.utils import config  # noqa: F401
