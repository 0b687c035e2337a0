"""Tests of the benchmark's own code, on the CPU at tiny sizes.

Run from the repository root: ``python -m pytest portbench/tests -q``.
Tests that need the card carry the ``card`` marker and decide inside the
test whether a card is present.
"""
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card; skips where there is none")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return "cuda"


def tiny(workload: str, **cfg_over):
    """(configuration, traffic) of ``workload`` cut to a CPU test's size:
    the widths and the slides shrink, the code paths stay."""
    from portbench import harness

    _, cfg, params = harness.resolve(workload)
    if cfg["family"] == "espnet_ensemble":
        cfg.update(q=2, in_height=64, in_width=128, crop_batch=4)
    else:
        cfg.update(hidden_sizes=[16, 32, 40, 64], depths=[1, 1, 1, 1],
                   decoder_hidden_size=32, input_size=64, crop_batch=4)
    cfg.update(cfg_over)
    params.update(slide_px=[1200, 1600], boxes_per_slide=[2, 7],
                  box_side_px=[80, 200], atlas_px=512, atlas_glomeruli=6,
                  glomerulus_radius_px=[30, 70], block_slides=4,
                  warmup_slides=2, check_slides=2)
    return cfg, params
