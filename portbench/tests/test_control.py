"""The control -- the reference put in the program's place, one
precision below the configuration's -- must come out not correct under
the cell's limit.  On the CPU at a tiny size for ESPNet (float8 runs
anywhere); on the card at the cells' own size for both (TF32 exists only
there), as ``portbench/control.py`` reads it."""
import pytest

from conftest import tiny
from portbench import harness
from portbench.control import reading

CELLS = ("espnet5-glom-dense", "segformer-b4-glom-dense")


def test_float8_control_fails_the_espnet_limit_on_the_cpu():
    cfg, params = tiny("espnet5-glom-dense")
    params["check_slides"] = 1
    r = reading(cfg, params, 2**31 + 3, 1, "cpu", control=True)
    assert r["pixels"] > 0 and r["stray"] == 0
    assert any(r[k] > limit for k, limit in cfg["limits"].items())


@pytest.mark.card
@pytest.mark.parametrize("workload", CELLS)
def test_control_fails_and_program_passes_at_the_cells_size(card,
                                                            workload):
    _, cfg, params = harness.resolve(workload)
    got = reading(cfg, params, 2**31 + 5, 8, card, control=False)
    ctl = reading(cfg, params, 2**31 + 5, 8, card, control=True)
    assert all(got[k] <= limit for k, limit in cfg["limits"].items())
    assert any(ctl[k] > limit for k, limit in cfg["limits"].items())


@pytest.mark.parametrize("seed", [2**31 + 11, 2**31 + 12, 2**31 + 13])
def test_segformer_labels_compete_on_every_seed(seed):
    """The seeded classifier is centred on the run's pixels, so no seed's
    draw makes one label win everywhere by its offset, where no precision
    could flip a pixel and the control would pass."""
    import numpy as np
    import torch

    from portbench import traffic
    from portbench.families import segformer
    from portbench.reference.segformer import Segformer

    cfg, params = tiny("segformer-b4-glom-dense")
    atlas = traffic.make_atlas(params, seed, "cpu")
    net = Segformer(cfg)
    net.load_state_dict(segformer.make_weights(cfg, seed, "cpu", atlas))
    s = cfg["input_size"]
    u8 = np.stack([segformer.cv2_resize(atlas[y: y + 256, x: x + 256], s)
                   for y, x in ((0, 0), (256, 128), (200, 256))])
    with torch.no_grad():
        logits = net.eval()(segformer._normalised(u8, "cpu"))
    labels = torch.bincount(logits.argmax(1).flatten(), minlength=5)
    assert int((labels > 0).sum()) >= 3
