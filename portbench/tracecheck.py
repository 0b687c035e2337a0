"""The trace's busy time against CUDA events, on the SegFormer cell's
model at its own batch and input size.

    python3 portbench/tracecheck.py --workload segformer-b4-glom-dense

Forwards of one crop batch are launched back to back, so the card never
waits for the host between them: CUDA events around the run then time the
device's busy span, and the union of the traced device operations' intervals
(``portbench/trace.py``, what ``idle_share.seg`` and ``device.busy_s``
read) has to come out the same.  A sum over overlapping streams would
read above the events, dropped records below.  Needs the card.
"""
import argparse
import json
import sys
import tempfile
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from portbench import harness  # noqa: E402
from portbench.stages import segment  # noqa: E402
from portbench.trace import DeviceTrace  # noqa: E402


def main(argv=None) -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--workload", default="segformer-b4-glom-dense")
    parser.add_argument("--batches", type=int, default=8)
    parser.add_argument("--seed", type=int, default=17)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("tracecheck: no CUDA device", file=sys.stderr)
        return 2
    _, cfg, params = harness.resolve(args.workload)
    family, _, weights = segment.inputs(cfg, params, args.seed, "cuda")
    with tempfile.TemporaryDirectory() as work:
        seg = family.build(cfg, weights, "cuda", work)
    s = cfg["input_size"]
    gen = torch.Generator(device="cuda")
    gen.manual_seed(args.seed)
    batch = torch.randint(0, 256, (cfg["crop_batch"], s, s, 3),
                          generator=gen, device="cuda", dtype=torch.uint8)
    for _ in range(2):
        seg.logits(batch)
    trace = DeviceTrace()
    trace.start()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(args.batches):
        seg.logits(batch)
    end.record()
    trace.stop()
    events_s = start.elapsed_time(end) / 1e3
    lo = min(t0 for _, t0, _ in trace.ops)
    hi = max(t1 for _, _, t1 in trace.ops)
    busy_s = trace.busy_s(lo, hi)
    summed_s = sum(t1 - t0 for _, t0, t1 in trace.ops) / 1e9
    print(json.dumps({
        "workload": args.workload, "batches": args.batches,
        "events_s": events_s, "trace_union_s": busy_s,
        "trace_sum_s": summed_s, "union_over_events": busy_s / events_s,
        "operations": len(trace.ops),
        "card": torch.cuda.get_device_name(0)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
