"""CLI: resident slide-serving daemon over the fused e2e pipeline, on the
GPU (``gseg-serve``).

    python -m glomeruli_segmentation_tpu_torch.cli.serve --model DIR \
        --segmentation_weights_dir DIR --spool_dir SPOOL --output_dir OUT

Counterpart of ``glomeruli_segmentation_tpu/cli/serve.py``, with the same
flags and defaults.  ``gseg-e2e`` pays CUDA start and model load per
invocation; ``gseg-serve`` pays them once and then processes slides as job
tickets arrive in a spool directory (see ``pipeline/serve.py`` for the
ticket contract).  Artifacts per slide are identical to ``gseg-e2e``'s, and
the flags ``gseg-e2e`` does not port raise here too.

Submit work::

    echo '{"slide_path": "/data/PAS-001.ndpi", "patient_id": "PAS-001"}' \
        > spool/job1.json

Stop the server::

    touch spool/STOP
"""
import argparse
import os

import torch

from .e2e import build_parser as build_e2e_parser


def build_parser() -> argparse.ArgumentParser:
    # reuse the e2e flag surface (model/ensemble/transfer knobs), minus
    # the batch-run inputs that the spool replaces
    base = build_e2e_parser()
    parser = argparse.ArgumentParser(
        description="resident detect+merge+segment+stitch server",
        parents=[], add_help=True)
    drop = {"--target_list", "--data_dir", "--resume"}
    for action in base._actions:  # noqa: SLF001 -- argparse has no public
        # API for selectively inheriting options from another parser
        if not action.option_strings or "-h" in action.option_strings:
            continue
        if drop & set(action.option_strings):
            continue
        parser._add_action(action)  # noqa: SLF001
    parser.add_argument("--spool_dir", type=str, required=True,
                        help="job-ticket directory (watched)")
    parser.add_argument("--poll_interval", type=float, default=2.0)
    parser.add_argument("--max_slides", type=int, default=None,
                        help="exit after N tickets (bounded runs/tests)")
    parser.add_argument("--stop_file", type=str, default=None,
                        help="exit when this file exists "
                             "(default <spool_dir>/STOP)")
    parser.add_argument("--server_id", type=str, default=None,
                        help="claim namespace for shared-spool "
                             "multi-server scale-out (default: hostname; "
                             "set when running several servers per host)")
    parser.add_argument("--recycle_rss_mb", type=int, default=None,
                        help="bounded-memory residency: when host RSS "
                             "exceeds this between waves, the server "
                             "re-execs itself with the same arguments "
                             "(spool claims, completed-slide resume and "
                             "the kernel libraries already built make the "
                             "restart seamless).  Guards against host-side "
                             "growth outside the server's control")
    return parser


def _reexec(argv) -> None:
    """Replace the process with a fresh server run (same argv)."""
    import sys

    os.execv(sys.executable,
             [sys.executable, "-m", "glomeruli_segmentation_tpu_torch.cli.serve"]
             + list(argv))


def _argv_with_max_slides(argv, remaining: int):
    """Rewrite --max_slides so a bounded run stays bounded across
    recycle restarts (the restarted process gets the REMAINING count)."""
    out = []
    skip = False
    for a in argv:
        if skip:
            skip = False
            continue
        if a == "--max_slides":
            skip = True
            continue
        if a.startswith("--max_slides="):
            continue
        out.append(a)
    return out + ["--max_slides", str(remaining)]


def main(argv=None, device="cuda"):
    """``device="cpu"`` runs every model on the CPU (for tests)."""
    import sys

    raw_argv = list(sys.argv[1:] if argv is None else argv)
    args = build_parser().parse_args(argv)

    from ..pipeline.serve import SlideServer
    from .detect import load_backend
    from .e2e import (build_pipeline, check_ported, resolve_mesh_policy,
                      resolve_slide_pipeline)

    check_ported(args)
    resolve_mesh_policy(args, torch.cuda.device_count()
                        if torch.device(device).type == "cuda" else 1)
    backend = load_backend(
        args.model, args.model_name, args.batch_size,
        od_api_overrides={"min_dimension": args.min_dimension,
                          "max_dimension": args.max_dimension,
                          "max_proposals": args.max_proposals,
                          "device_resize": args.device_resize,
                          "compat_tf1_resize": not args.cv2_resize},
        data_parallel=args.data_parallel, device=device)
    pipe = build_pipeline(args, backend, device=device)

    json_dir = (None if args.no_json
                else args.json_dir or os.path.join(args.output_dir, "json"))
    server = SlideServer(pipe, args.spool_dir, args.output_dir,
                         json_dir=json_dir,
                         write_overlay=not args.no_overlay,
                         poll_interval=args.poll_interval,
                         stop_file=args.stop_file,
                         server_id=args.server_id,
                         pipeline=resolve_slide_pipeline(args),
                         recycle_rss_mb=args.recycle_rss_mb)
    n = server.serve(max_slides=args.max_slides)
    print(f"served {n} ticket(s)")
    if server.recycle_requested:
        # bounded-memory residency: restart with identical argv; the spool
        # lifecycle and completed-slide resume make the hand-off seamless
        if args.max_slides is None:
            _reexec(raw_argv)
        elif args.max_slides - n > 0:
            _reexec(_argv_with_max_slides(raw_argv, args.max_slides - n))


if __name__ == "__main__":
    main()
