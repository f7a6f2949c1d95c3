"""nonstationary_precip_tpu_torch — the PyTorch/CUDA port of nonstationary_precip_tpu.

The JAX package beside it is the reference; this package keeps its module
paths and public names so each counterpart is found at the same place, and
never imports jax (nor the JAX package, whose config imports jax).

Layering (bottom-up), as far as the port reaches today:
  ops/      — dense linear algebra; ``chol_inv`` wraps the hand-written
              CUDA batched (L, L⁻¹) kernel (``csrc/chol_inv_batched.cu``)
  kernels/  — the Gibbs and squared-distance covariance functions
  priors/   — the log-normal latent-lengthscale process (dense part)
  models/   — Gaussian likelihood, MVN, the Gibbs exact GP (MAP)
  train/    — Adam loop, the split-batched trainer, metrics, config
  data/     — numpy CSV loader and the seeded split harness
  interop   — carries JAX model weights into the port's modules
"""

__version__ = "0.1.0"

from nonstationary_precip_tpu_torch.utils import config  # noqa: F401
