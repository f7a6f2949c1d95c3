"""Build a CUDA source of the port into a shared library and load it.

Every hand-written kernel of the port is CUDA C++ for sm_90a with a plain C
interface.  nvcc compiles it at first use into ``build/torch_kernels/``,
under a name made from the hash of the source, the shared headers and the
flags, and ctypes
loads it: no PyTorch headers, so a build takes seconds.  The wrappers pass
pointers and the stream as ``ctypes.c_void_p``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

from nonstationary_precip_tpu_torch.utils.config import BASE_PATH

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = BASE_PATH / "build" / "torch_kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]


def nvcc() -> str:
    """Path of nvcc: ``$CUDA_HOME/bin/nvcc`` (default /usr/local/cuda), else
    the one on PATH."""
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for cand in (Path(cuda_home) / "bin" / "nvcc", shutil.which("nvcc")):
        if cand and Path(cand).is_file():
            return str(cand)
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")


def build_library(source: Path, force: bool = False) -> tuple[ctypes.CDLL, str]:
    """Compile ``source`` into ``build/torch_kernels/lib<stem>_<hash>.so``
    and load it.  Returns (library, nvcc's output: the ``-Xptxas -v``
    register, shared-memory and spill report).  A library already built
    from the same source and flags is reused unless ``force``.  A failed
    compile raises.  The hash covers the shared headers (``csrc/*.cuh``)
    that a source may include."""
    src = source.read_bytes() + b"".join(h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
    tag = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    out = BUILD_DIR / f"lib{source.stem}_{tag}.so"
    log = ""
    if force or not out.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        proc = subprocess.run([nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(source)],
                              capture_output=True, text=True)
        log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}) on {source}:\n{log}")
        os.replace(tmp, out)
    return ctypes.CDLL(str(out)), log
