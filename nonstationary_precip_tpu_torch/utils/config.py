"""Global configuration constants and the device helper.

Counterpart of ``nonstationary_precip_tpu/utils/config.py``: the same
numerical-policy constants (jitter EPSILON, BASE_SEED) and paths, with
PyTorch's precision pins in place of JAX's matmul-precision flag.
"""

import os
from pathlib import Path

import torch

# GP linear algebra is precision-critical (DESIGN.md §4 and §17: reduced
# precision in the distance Grams and the CG solves diverges training).
# TF32 keeps ~3 decimal digits, so both switches are pinned off.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

#: Cholesky jitter added to kernel matrices (reference: EPSILON = 1e-5).
EPSILON = 1e-5

#: Base RNG seed shared by all experiments (reference: BASE_SEED = 173).
BASE_SEED = 173

BASE_PATH = Path(__file__).parent.parent.parent
DATASET_DIR = BASE_PATH / "data"
#: Default artifact directory of the port — apart from the JAX package's
#: ``results/`` so the shipped reference artifacts are never overwritten.
DEFAULT_RESULTS_DIR = BASE_PATH / "results" / "torch"


def results_dir() -> Path:
    """Where experiment drivers write artifacts: ``$NSGP_RESULTS_DIR`` if
    set (read at call time, so a smoke run can redirect it), else
    ``results/torch/``."""
    return Path(os.environ.get("NSGP_RESULTS_DIR", DEFAULT_RESULTS_DIR))


def device(name: str = "cuda") -> torch.device:
    """The torch device called ``name``.  Asking for CUDA where there is
    none raises: a run meant for the card never carries on on the CPU."""
    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {name!r} requested but CUDA is not available")
    return dev
