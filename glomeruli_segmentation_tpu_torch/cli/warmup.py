"""CLI: build the port's kernels and run every production shape once
(``gseg-warmup``), on the GPU.

    python -m glomeruli_segmentation_tpu_torch.cli.warmup \
        --segmentation_weights_dir DIR --model DIR

Counterpart of ``glomeruli_segmentation_tpu/cli/warmup.py``, with the same
flags and defaults.  The JAX command fills the persistent XLA compile cache
so that later runs skip minutes of compiles.  The port's counterpart of
that cache is ``build/torch_kernels/``: ``ops/_build.build_all()`` compiles
every CUDA source there with ``nvcc``, and every later process of this
checkout loads the libraries instead of compiling them.  On the card it
also builds the native slide reader (``wsi/native/_build.build()``, ``g++``
into ``build/native_reader/``), so the server's first ticket does not pay
for the compiler.  Those builds are the only warm state that outlives this
process.  PyTorch compiles nothing per
shape, so the calls that follow warm nothing persistent: they run each
shape a server or ``gseg-e2e`` run will use once on this card, in the JAX
command's order, and fail here rather than in the first request:

- the 5-fold ESPNet ensemble, full-resolution and /8 stitch-gather
  forwards, at each crop bucket in the padded layout;
- the same two forwards through the flat transfer, at each requested
  eighth of the padded batch's bytes (the flat buffer lengths
  ``ops/preprocess.pack_crops_flat`` quantizes to);
- the detector at each window size, when ``--model`` is given.

``--engine xla`` and ``--pack_output`` are not ported and raise.
"""
import argparse
import os
import time


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        description="build the kernels and run each production shape once")
    parser.add_argument("--segmentation_weights_dir", type=str, default=None,
                        help="directory holding espnet_fold{1..5}.pth")
    parser.add_argument("--folds", type=int, nargs="*", default=[1, 2, 3, 4, 5])
    parser.add_argument("--seg_batch_size", type=int, default=32)
    parser.add_argument("--engine", default="auto",
                        choices=["auto", "xla", "fused", "packed"],
                        help="'xla' is not ported")
    parser.add_argument("--buckets", type=int, nargs="*", default=[512],
                        help="crop bucket sizes (multiples of 256) to warm")
    parser.add_argument("--transfer", default="both",
                        choices=["both", "padded", "flat"],
                        help="crop-transfer layouts to warm (flat is the "
                             "production default)")
    parser.add_argument("--flat_eighths", type=int, nargs="*",
                        default=[5, 6, 7, 8, 9],
                        help="flat buffer lengths to warm, in eighths of "
                             "the padded batch bytes")
    parser.add_argument("--pack_output", action="store_true",
                        help="not ported")
    parser.add_argument("--model", type=str, default=None,
                        help="detector model dir (optional)")
    parser.add_argument("--model_name", default=None,
                        help="detector file inside --model (default: "
                             "auto-discover; see gseg-detect --help)")
    parser.add_argument("--window_sizes", type=int, nargs="*", default=[1024],
                        help="detection window pixel sizes to warm")
    parser.add_argument("--batch_size", type=int, default=8,
                        help="detection window batch size")
    parser.add_argument("--device_resize", action="store_true")
    return parser


def main(argv=None, device="cuda"):
    """``device="cpu"`` runs the shapes on the CPU (for tests) and builds
    no kernel: on the CPU every kernel wrapper runs its plain version."""
    args = build_parser().parse_args(argv)
    import numpy as np

    from .. import resolve_device

    unported = (["--engine xla"] if args.engine == "xla" else []) + \
        (["--pack_output"] if args.pack_output else [])
    if unported:
        raise SystemExit("not ported: " + ", ".join(unported))
    if resolve_device(device).type == "cuda":
        from ..ops import _build

        t0 = time.perf_counter()
        _build.build_all()
        print(f"kernels in {_build.BUILD_DIR}: {', '.join(_build.SOURCES)} "
              f"({time.perf_counter() - t0:.2f} s, nvcc "
              + (", ".join(f"{name} {sec:.2f} s" for name, (sec, _)
                           in _build.build_log.items()) or "not needed")
              + ")", flush=True)
        from ..wsi.native import _build as reader_build

        t0 = time.perf_counter()
        try:
            built = f"built in {reader_build.build()}"
        except OSError as e:  # open_slide then reads with the Python reader
            built = f"unavailable: {e}"
        print(f"native slide reader {built} ({time.perf_counter() - t0:.2f}"
              " s, g++ " + (f"{reader_build.build_log[0]:.2f} s"
                            if reader_build.build_log else "not needed")
              + ")", flush=True)

    did = []
    if args.segmentation_weights_dir:
        from ..ops.preprocess import flat_quantum
        from ..pipeline.fused import EnsembleConfig, EnsembleSegmenter

        ckpts = [os.path.join(args.segmentation_weights_dir,
                              f"espnet_fold{k}.pth") for k in args.folds]
        ens = EnsembleSegmenter(
            EnsembleConfig(checkpoints=ckpts, folds=tuple(args.folds),
                           batch_size=args.seg_batch_size),
            engine=args.engine, device=device)
        bs = args.seg_batch_size
        for bucket in args.buckets:
            hs = np.full(bs, bucket - 62, np.int32)
            ys = np.zeros((bs, bucket // 8), np.int32)
            xs = np.zeros((bs, bucket // 8), np.int32)
            if args.transfer in ("both", "padded"):
                padded = np.zeros((bs, bucket, bucket, 3), np.uint8)
                print(f"warming ensemble bucket {bucket} (full-res path)...",
                      flush=True)
                ens.segment_batch_padded(padded, hs, hs)
                print(f"warming ensemble bucket {bucket} (/8 gather "
                      "path)...", flush=True)
                ens.segment_batch_gather(padded, hs, hs, ys, xs)
                did.append(f"ensemble@{bucket}")
            if args.transfer in ("both", "flat"):
                # the quantum must be pack_crops_flat's own, or the warm-up
                # runs lengths production never uses
                quantum = flat_quantum(bs, bucket, bucket)
                offs = np.zeros(bs, np.int32)
                ones = np.ones(bs, np.int32)
                for k in args.flat_eighths:
                    flat = np.zeros(k * quantum, np.uint8)
                    print(f"warming ensemble bucket {bucket} flat {k}/8 "
                          "(full-res + /8 gather)...", flush=True)
                    ens.read_maps(ens.submit_batch_flat(
                        flat, offs, ones, ones, bucket, bucket))
                    ens.read_maps(ens.submit_batch_gather_flat(
                        flat, offs, ones, ones, ys, xs, bucket, bucket))
                    did.append(f"ensemble@{bucket}:flat{k}/8")

    if args.model:
        from .detect import load_backend

        backend = load_backend(args.model, args.model_name, args.batch_size,
                               od_api_overrides={
                                   "device_resize": args.device_resize},
                               device=device)
        for wsize in args.window_sizes:
            print(f"warming detector window {wsize}...", flush=True)
            windows = np.zeros((args.batch_size, wsize, wsize, 3), np.uint8)
            backend.detect_batch(windows)
            did.append(f"detector@{wsize}")

    if not did:
        raise SystemExit("nothing to warm: pass --segmentation_weights_dir "
                         "and/or --model")
    print("warmed:", ", ".join(did))


if __name__ == "__main__":
    main()
