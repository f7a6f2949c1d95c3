"""The sequential single-split oracles run where their configuration says.

``run_one_split`` of ``experiments/deepgp_spatial.py`` and
``experiments/seard_spatial.py`` take their device from ``cfg.device``
unless the caller passes one, so a configuration that names the card runs
there or raises: it never carries on on the CPU.  Here no card is
reported, so the device helper (``utils/config.device``) raises before any
data is touched.
"""

import pytest
import torch

from nonstationary_precip_tpu_torch.experiments import deepgp_spatial, seard_spatial


@pytest.mark.parametrize("module", [deepgp_spatial, seard_spatial], ids=["deepgp_spatial", "seard_spatial"])
def test_run_one_split_takes_the_configured_device(monkeypatch, module):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = module.default_config().parse_args(["--device", "cuda"])
    assert cfg.device == "cuda"
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        module.run_one_split(None, 0, cfg)  # raises before the data is read
