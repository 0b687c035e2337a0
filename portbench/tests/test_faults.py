"""A run with the timed path broken underneath must come out not
correct: the harness's look for a card skipped, the rest of a run driven
on the CPU at a tiny size, with each fault a segment cell can have -- half
of each batch's crops left out, and one crop's answer altered where it is
produced, in one batch slot.  (A single-card stateless stage has no
state to leave unchanged and no exchange between cards.)  The same run
unbroken, with the program in float32, agrees with the reference
exactly."""
import time

import numpy as np
import pytest

from conftest import tiny
from portbench import harness
from portbench.stages import segment

CELLS = ("espnet5-glom-dense", "segformer-b4-glom-dense")


def reads(family, seg):
    owner, attr = family.result_reads(seg)[0]
    return owner, attr, getattr(owner, attr)


def patch(owner, attr, fn):
    own = attr in vars(owner)
    orig = getattr(owner, attr)
    setattr(owner, attr, fn)

    def mend():
        if own:
            setattr(owner, attr, orig)
        else:
            delattr(owner, attr)
    return mend


def half_left_out(family, seg):
    owner, attr, orig = reads(family, seg)

    def read(handle):
        maps = np.array(orig(handle))
        maps[len(maps) // 2:] = 0
        return maps
    return patch(owner, attr, read)


def one_answer_altered(family, seg):
    """The first crop's map of every batch altered: a fault of one batch
    slot, which every slide shows (a sample of slides is checked)."""
    owner, attr, orig = reads(family, seg)

    def read(handle):
        maps = np.array(orig(handle))
        maps[0] = (maps[0] + 1) % 5
        return maps
    return patch(owner, attr, read)


def correct(workload, cfg, params, tamper=None, seconds=1.0):
    outcome = segment.run(None, cfg, params, 2**31 + 17, seconds, False,
                          time.perf_counter(), device="cpu", tamper=tamper)
    line = harness.result(harness.manifest(), workload, outcome, False,
                          {"platform": "cpu"})
    return line, outcome


@pytest.mark.parametrize("workload", CELLS)
@pytest.mark.parametrize("fault", [half_left_out, one_answer_altered])
def test_a_broken_program_is_not_correct(workload, fault):
    cfg, params = tiny(workload)
    line, outcome = correct(workload, cfg, params, fault)
    assert line["correct"] is False
    assert any(v > limit for k, (v, limit) in outcome["checks"].items()
               if k in cfg["limits"])
    assert list(line)[-1] == "checks"


@pytest.mark.parametrize("workload", CELLS)
def test_the_program_in_float32_agrees_with_the_reference(workload):
    cfg, params = tiny(workload, compute_dtype="float32",
                       precision="highest")
    line, outcome = correct(workload, cfg, params, seconds=0.1)
    assert line["correct"] is True
    assert outcome["compared"]["canvas_gap"] <= 1e-5
    assert outcome["compared"]["mismatch_share"] == 0
    assert outcome["compared"]["pixels"] > 0
    assert set(line["metrics"]) == {"crops_per_s", "slide_s_p90",
                                    "setup_s"}
