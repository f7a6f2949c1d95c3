"""Pin the JAX package's ``parallel/`` results that tests/test_torch_parallel.py
and tests/test_torch_sharded_cg.py hold the port to, as committed fixtures
(tests/fixtures/jax_parallel_ref.npz, tests/fixtures/jax_sharded_cg_ref.npz).

What is pinned: each file's ``jax_ref_live(p)`` at P = 1, 2 and 4, on virtual
CPU meshes of as many devices in float64, from the inputs each file makes
(its ``models()`` / ``cases()``: numpy seeds and JAX keys), exactly as the
tests computed them live before, with the digest of those inputs
(``inputs_digest``), which each file checks on load.  Both files keep
``jax_ref_live``, and each recomputes two of its cases live at P = 2 and
one at P = 4 against the fixture (``test_pinned_jax_reference_*``), so a
fixture that no longer matches the JAX package or the inputs fails there.

The JAX set-up is the test suite's own (tests/conftest.py: CPU, x64, 8
virtual devices, the compilation cache), imported before anything else.

Run: python tools/pin_jax_parallel.py  (about 100 s on an idle 8-core CPU;
regenerate deliberately, after changing either file's inputs).
"""

import sys
import time
from pathlib import Path

TESTS = Path(__file__).resolve().parents[1] / "tests"
sys.path[:0] = [str(TESTS), str(TESTS.parent)]

import conftest  # noqa: E402,F401  (the tests' JAX set-up, before JAX runs anything)
import pinned_refs  # noqa: E402
import test_torch_parallel  # noqa: E402
import test_torch_sharded_cg  # noqa: E402


def main():
    for mod in (test_torch_parallel, test_torch_sharded_cg):
        t0 = time.perf_counter()
        refs = {p: mod.jax_ref_live(p) for p in mod.WORLDS}
        refs[pinned_refs.DIGEST] = mod.inputs_digest()
        pinned_refs.save(mod.JAX_REF, refs)
        print(f"{mod.JAX_REF.name}: {len(pinned_refs.flatten(refs))} arrays in {time.perf_counter() - t0:.1f} s")


if __name__ == "__main__":
    main()
