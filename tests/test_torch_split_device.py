"""The experiments' per-split helpers run where their configuration says.

``run_one_split`` of ``experiments/deepgp_spatial.py`` and
``experiments/seard_spatial.py``, ``prep_split`` of the deep GP,
``make_split`` of SE-ARD, and ``spatial_field`` and ``st_field_pattern`` of
``experiments/field_regression.py`` take their device from ``cfg.device``
unless the caller passes one, so a configuration that names the card runs
there or raises: it never carries on on the CPU.  Here no card is
reported, so the device helper (``utils/config.device``) raises before any
data is touched.
"""

import pytest
import torch

from nonstationary_precip_tpu_torch.experiments import deepgp_spatial, field_regression, seard_spatial


@pytest.mark.parametrize("module", [deepgp_spatial, seard_spatial], ids=["deepgp_spatial", "seard_spatial"])
def test_run_one_split_takes_the_configured_device(monkeypatch, module):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = module.default_config().parse_args(["--device", "cuda"])
    assert cfg.device == "cuda"
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        module.run_one_split(None, 0, cfg)  # raises before the data is read


@pytest.mark.parametrize("module,call", [
    (deepgp_spatial, lambda cfg: deepgp_spatial.prep_split(None, 0, cfg)),
    (seard_spatial, lambda cfg: seard_spatial.make_split(None, 0, cfg)),
    (field_regression, lambda cfg: field_regression.spatial_field(cfg)),
    (field_regression, lambda cfg: field_regression.st_field_pattern(cfg)),
], ids=["deepgp_spatial.prep_split", "seard_spatial.make_split", "field_regression.spatial_field",
        "field_regression.st_field_pattern"])
def test_split_helpers_take_the_configured_device(monkeypatch, module, call):
    """Given only ``cfg``, each helper asks for ``cfg.device``: the card,
    absent here, so it raises before it reads or builds anything.  Given
    ``--device cpu`` it would run on the CPU, as the CPU tests do."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = module.default_config().parse_args(["--device", "cuda"])
    assert cfg.device == "cuda"
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        call(cfg)
