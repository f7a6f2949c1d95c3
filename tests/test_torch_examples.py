"""Smoke-run the port's ported quickstarts at tests/test_examples.py's tiny
budgets, on the CPU: each runs its own asserts and prints "ok", as the JAX
examples do.  Their models are held to JAX in the module tests
(``test_torch_dense_cg.py``, ``test_torch_full_cov.py``, the exact, Gibbs
and deep GP files); chip_smoke.py runs them at their defaults on the card.
"""

import pytest
import torch

from nonstationary_precip_tpu_torch.examples import (
    quickstart_cg_largen,
    quickstart_deepgp,
    quickstart_exact_gp,
    quickstart_gibbs_spatial,
    quickstart_lazy_largen,
)

torch.set_num_threads(1)

CASES = {
    "exact_gp": lambda: quickstart_exact_gp.main(num_steps=20, dev="cpu"),
    "gibbs_spatial": lambda: quickstart_gibbs_spatial.main(max_iters=5, dev="cpu"),
    "deepgp": lambda: quickstart_deepgp.main(num_epochs=2, dev="cpu"),
    "cg_largen": lambda: quickstart_cg_largen.main(n=300, num_steps=4, dev="cpu"),
    "lazy_largen": lambda: quickstart_lazy_largen.main(n=240, num_steps=4, block=60, dev="cpu"),
}


@pytest.mark.parametrize("name", list(CASES))
def test_quickstart(name, capsys):
    CASES[name]()
    assert "ok" in capsys.readouterr().out.splitlines()


@pytest.mark.parametrize("name", list(CASES))
def test_quickstart_runs_on_the_card_by_default(name):
    """Without a device argument each quickstart asks for the card, and
    raises where there is none."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    main = {"exact_gp": quickstart_exact_gp, "gibbs_spatial": quickstart_gibbs_spatial, "deepgp": quickstart_deepgp,
            "cg_largen": quickstart_cg_largen, "lazy_largen": quickstart_lazy_largen}[name].main
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        main()
