"""CLI: real-artifact acceptance harness (``gseg-selftest``), on the GPU.

    python -m glomeruli_segmentation_tpu_torch.cli.selftest \
        --ndpi SLIDE --pb frozen_inference_graph.pb --out verdict.json

The reference mirror strips the real NDPI slides and the downloadable
frozen detector graph (the reference's ``example/README.md:20-38``); this
command runs the acceptance checks against the real artifacts the moment
they are available and writes a verdict JSON — see
``pipeline/selftest.py`` for the check list.  Counterpart of
``glomeruli_segmentation_tpu/cli/selftest.py``, with the same flags and
defaults (``GSEG_REAL_NDPI``, ``GSEG_REAL_PB``); the detector runs on the
card.
"""
import argparse
import json
import os
import sys


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        description="acceptance checks for real NDPI / frozen-graph "
                    "artifacts (graceful skip when absent)")
    parser.add_argument("--ndpi", type=str,
                        default=os.environ.get("GSEG_REAL_NDPI"),
                        help="a real scanner-written slide (.ndpi/.tiff); "
                             "default $GSEG_REAL_NDPI")
    parser.add_argument("--pb", type=str,
                        default=os.environ.get("GSEG_REAL_PB"),
                        help="a real frozen_inference_graph.pb; "
                             "default $GSEG_REAL_PB")
    parser.add_argument("--out", type=str, default="selftest_verdict.json",
                        help="verdict JSON path ('' = stdout only)")
    return parser


def main(argv=None, device="cuda") -> int:
    """``device="cpu"`` runs the detector on the CPU (for tests)."""
    args = build_parser().parse_args(argv)
    from ..pipeline.selftest import run_selftest

    verdict = run_selftest(ndpi=args.ndpi, pb=args.pb,
                           out=args.out or None, device=device)
    print(json.dumps(verdict, indent=2))
    if not verdict["checks_run"]:
        print("nothing to check: point --ndpi/--pb (or GSEG_REAL_NDPI/"
              "GSEG_REAL_PB) at the real artifacts", file=sys.stderr)
    return 0 if verdict["ok"] else 2


if __name__ == "__main__":
    raise SystemExit(main())
