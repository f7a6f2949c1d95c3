"""Spawn a group of ranks, one process each, and gather what they return.

``spawn("pkg.module:function", world, device=..., args=...)`` starts
``world`` processes of ``python -m nonstationary_precip_tpu_torch.parallel.launch``.
Each joins the group through a ``FileStore`` in a fresh directory (no
network), calls ``function(*args)`` and saves what it returns; the parent
returns the ranks' results in rank order (``start`` returns the running
group instead, whose ``join`` waits for it).  On the CPU the group is gloo
(the counterpart of JAX's virtual CPU devices); on CUDA it is NCCL, rank r
on card r mod device_count.

No group is left hanging: every group waits at most ``group_timeout`` in a
collective, a rank that fails stops the others at once, and past
``deadline`` seconds every rank is killed; each case raises.
"""

from __future__ import annotations

import os
import subprocess
import sys
import tempfile
import time
import traceback
from datetime import timedelta
from pathlib import Path
from typing import Sequence

import torch

from nonstationary_precip_tpu_torch.parallel.mesh import GROUP_TIMEOUT

REPO_ROOT = Path(__file__).resolve().parents[2]
DEADLINE = 600.0  # seconds a spawned group may run in all


def _tail(path: Path, limit: int = 4000) -> str:
    text = path.read_text(errors="replace") if path.exists() else ""
    return text[-limit:]


class Group:
    """A spawned group of ranks (:func:`start`); :meth:`join` waits for it."""

    def __init__(self, target: str, world: int, work: Path, procs: list, deadline: float, echo: bool):
        self.target, self.world, self.work, self.procs = target, world, work, procs
        self.deadline, self.echo, self.t0 = deadline, echo, time.monotonic()

    def join(self) -> list:
        """The ranks' results in rank order.  Raises RuntimeError when a rank
        fails (with its log) and TimeoutError past the deadline; either way
        every rank still running is killed first."""
        try:
            while True:
                codes = [p.poll() for p in self.procs]
                bad = [r for r, c in enumerate(codes) if c not in (None, 0)]
                if bad:
                    raise RuntimeError(f"spawn {self.target}: rank {bad[0]} of {self.world} failed "
                                       f"(exit {codes[bad[0]]}):\n" + _tail(self.work / f"log{bad[0]}.txt"))
                if all(c == 0 for c in codes):
                    break
                if time.monotonic() - self.t0 > self.deadline:
                    raise TimeoutError(f"spawn {self.target}: {self.world} ranks past the {self.deadline:.0f} s "
                                       "deadline; killed")
                time.sleep(0.05)
        finally:
            for p in self.procs:
                if p.poll() is None:
                    p.kill()
            for p in self.procs:
                p.wait()
        if self.echo:
            sys.stdout.write((self.work / "log0.txt").read_text(errors="replace"))
            sys.stdout.flush()
        return [torch.load(self.work / f"out{r}.pt", weights_only=False) for r in range(self.world)]


def start(target: str, world: int, *, device: str = "cpu", args: Sequence = (), workdir=None,
          deadline: float = DEADLINE, group_timeout: timedelta = GROUP_TIMEOUT, paths: Sequence = (),
          echo: bool = True) -> Group:
    """Start ``target`` ("module:function") on ``world`` ranks and return
    the running :class:`Group` (``spawn`` without the wait).

    Each rank calls ``init_world`` (gloo for ``device="cpu"``, NCCL for
    "cuda") and then ``function(*args)``; ``args`` and the results go
    through ``torch.save``.  ``workdir`` holds the store, the arguments and
    each rank's output and log (a new temporary directory by default);
    ``paths`` go ahead of the repository on the children's ``sys.path``;
    ``deadline`` counts from here.  Each child computes on one CPU thread.  Rank 0's standard output is printed at the join when ``echo``."""
    work = Path(workdir or tempfile.mkdtemp(prefix="nsgp_spawn_"))
    work.mkdir(parents=True, exist_ok=True)
    spec = work / "spec.pt"
    torch.save({"target": target, "world": world, "device": device, "args": tuple(args),
                "timeout": group_timeout.total_seconds(), "store": str(work / "store")},
               spec)
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join([*map(str, paths), str(REPO_ROOT), *filter(None, [env.get("PYTHONPATH")])])
    procs = []
    try:
        for rank in range(world):
            with open(work / f"log{rank}.txt", "wb") as log:
                procs.append(subprocess.Popen(
                    [sys.executable, "-m", "nonstationary_precip_tpu_torch.parallel.launch", str(spec), str(rank)],
                    stdout=log, stderr=subprocess.STDOUT, env=env, cwd=str(REPO_ROOT)))
    except BaseException:
        for p in procs:
            p.kill()
            p.wait()
        raise
    return Group(target, world, work, procs, deadline, echo)


def spawn(target: str, world: int, **kw) -> list:
    """Run ``target`` on ``world`` ranks and return their results in rank
    order: :func:`start`, then :meth:`Group.join`."""
    return start(target, world, **kw).join()


def _call(target: str, args: Sequence):
    import importlib

    module, _, name = target.partition(":")
    return getattr(importlib.import_module(module), name)(*args)


def run_ranks(target: str, world=None, device: str = "cuda", args: Sequence = (), **kw):
    """Rank 0's result of ``target(*args)`` run on every rank of a group: in
    this process when it already belongs to one (the caller made it, as
    ``chip_smoke.py`` does), else on ``world`` spawned ranks (default: every
    card for ``device="cuda"``, one CPU rank for "cpu"; a CUDA request
    without a card raises here).  ``kw`` goes to :func:`spawn`."""
    import torch.distributed as dist

    from nonstationary_precip_tpu_torch.utils.config import device as _device

    if dist.is_initialized():
        return _call(target, args)
    if _device(device).type == "cuda":
        world = world or torch.cuda.device_count()
    return spawn(target, world or 1, device=device, args=args, **kw)[0]


def _child(spec_path: str, rank: int) -> int:
    import torch.distributed as dist

    from nonstationary_precip_tpu_torch.parallel.mesh import init_world

    spec = torch.load(spec_path, weights_only=False)
    torch.set_num_threads(1)  # P ranks share the host's cores
    init_world(spec["world"], rank, spec["store"], spec["device"], timedelta(seconds=spec["timeout"]))
    out = _call(spec["target"], spec["args"])
    torch.save(out, Path(spec_path).parent / f"out{rank}.pt")
    dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    try:
        sys.exit(_child(sys.argv[1], int(sys.argv[2])))
    except Exception:
        traceback.print_exc()
        sys.stdout.flush()
        os._exit(1)
