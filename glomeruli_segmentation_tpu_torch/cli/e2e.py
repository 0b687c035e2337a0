"""CLI: fused end-to-end slide pipeline (detect -> merge -> segment ->
stitch in one process) on the GPU.

    python -m glomeruli_segmentation_tpu_torch.cli.e2e --model DIR \
        --target_list LIST --data_dir DIR --segmentation_weights_dir DIR
    python -m glomeruli_segmentation_tpu_torch.cli.e2e --model DIR \
        --target_list LIST --data_dir DIR --segformer_checkpoint CKPT

Counterpart of ``glomeruli_segmentation_tpu/cli/e2e.py`` (``gseg-e2e``),
with the same flags and defaults: per slide it emits the merged-detection
CSV, the timing log, the per-crop labelme JSONs (with
``--segformer_checkpoint``, the GTCS model family's mode-'L' label PNGs)
and the stitched ``{patient}_pred.jpg``.  Flags whose machinery is not
ported raise ``SystemExit`` naming themselves when set to anything but
their default: ``--mesh auto`` on more than one card, ``--data_parallel``,
``--fold_parallel``, ``--host_resize``, ``--pack_output`` and ``--engine
xla``.
"""
import argparse
import os

import torch


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        description="fused detect+merge+segment+stitch per slide")
    parser.add_argument("--model", type=str, required=True,
                        help="detector model dir (detector.ckpt.pth or "
                             "frozen_inference_graph.pb)")
    parser.add_argument("--target_list", type=str, required=True)
    parser.add_argument("--data_dir", type=str, required=True)
    parser.add_argument("--staining", dest="data_category", type=str,
                        default="OPT_PAS")
    parser.add_argument("--output_dir", type=str, default="./output")
    parser.add_argument("--segmentation_weights_dir", type=str, default=None,
                        help="directory holding espnet_fold{1..5}.pth "
                             "(required unless --segformer_checkpoint)")
    parser.add_argument("--folds", type=int, nargs="*", default=[1, 2, 3, 4, 5])
    parser.add_argument("--segformer_checkpoint", type=str, default=None,
                        help="run the SegFormer/GTCS model family instead "
                             "of the 5-fold ESPNet ensemble: a "
                             "flax_model.pth, a checkpoint-N dir, or a "
                             "training output dir (best checkpoint found "
                             "via log.txt); per-crop artifacts become the "
                             "GTCS label PNGs (mode-'L' grayscale) and the "
                             "overlay uses the GTCS palette")
    parser.add_argument("--num_labels", type=int, default=None,
                        help="GTCS class count (SegFormer path; default: "
                             "recorded in the checkpoint)")
    parser.add_argument("--input_size", type=int, default=512,
                        help="SegFormer input resolution")
    parser.add_argument("--json_dir", type=str, default=None,
                        help="write per-crop labelme JSONs here "
                             "(default: <output_dir>/json)")
    parser.add_argument("--no_json", action="store_true",
                        help="skip per-crop labelme JSONs; unlocks the "
                             "device-side /8 stitch gather (full-res "
                             "class maps never cross the d2h link)")
    parser.add_argument("--window_size", type=int, default=2000)
    parser.add_argument("--overlap_ratio", type=float, default=0.1)
    parser.add_argument("--conf_threshold", type=float, default=0.2)
    parser.add_argument("--merge_conf_threshold", type=float, default=0.9)
    parser.add_argument("--merge_overlap_threshold", type=float, default=0.35)
    parser.add_argument("--batch_size", type=int, default=8)
    parser.add_argument("--seg_batch_size", type=int, default=32)
    parser.add_argument("--model_name", default=None,
                        help="detector file inside --model (default: "
                             "auto-discover: detector.ckpt.pth > "
                             "od_api_detector.ckpt.pth > "
                             "frozen_inference_graph.pb)")
    parser.add_argument("--engine", default="auto",
                        choices=["auto", "xla", "fused", "packed"],
                        help="'fused' loops over folds through the fused "
                             "ESP block kernel; 'packed' runs all folds in "
                             "one block-diagonal forward; 'auto' (default) "
                             "picks packed below batch 96, fused above; "
                             "'xla' is not ported")
    parser.add_argument("--precision", default="default",
                        choices=["default", "high", "highest"])
    parser.add_argument("--mesh", default="auto", choices=["auto", "off"],
                        help="'auto' (default): on a multi-card host, a "
                             "fold x data mesh (not ported: raises there); "
                             "one card resolves to no mesh")
    parser.add_argument("--data_parallel", type=int, default=0,
                        help="not ported: must stay 0")
    parser.add_argument("--fold_parallel", type=int, default=0,
                        help="not ported: must stay 0")
    parser.add_argument("--min_dimension", type=int, default=600)
    parser.add_argument("--max_dimension", type=int, default=1024)
    parser.add_argument("--max_proposals", type=int, default=300)
    parser.add_argument("--device_resize", action="store_true",
                        help="resize windows on the card after the upload "
                             "(frozen-graph backend)")
    parser.add_argument("--cv2_resize", action="store_true",
                        help="cv2 half-pixel keep-aspect resize instead of "
                             "the frozen graph's TF1 scale*i sampling")
    parser.add_argument("--transfer", default="auto",
                        choices=["auto", "flat", "padded"],
                        help="crop batch transfer layout: 'flat' ships one "
                             "ragged byte buffer (the padded view rebuilt "
                             "on the card, byte-identical); 'padded' ships "
                             "the max-shape batch; 'auto' is flat")
    parser.add_argument("--host_resize", action="store_true",
                        help="not ported")
    parser.add_argument("--pack_output", action="store_true",
                        help="not ported")
    parser.add_argument("--no_overlay", action="store_true")
    parser.add_argument("--slide_pipeline", default="auto",
                        choices=["auto", "on", "off"],
                        help="cross-slide pipelining: detection of slide "
                             "N+1 / segmentation of N / artifact emission "
                             "of N-1 stream on three threads (artifacts "
                             "identical and identically ordered either "
                             "way).  'auto' (default) enables it when the "
                             "host has >=2 usable CPU cores")
    parser.add_argument("--serial_slides", action="store_true",
                        help="alias for --slide_pipeline off")
    parser.add_argument("--resume", action="store_true",
                        help="skip slides already in the timing log and "
                             "append to the merged CSV instead of starting "
                             "fresh")
    return parser


def check_ported(args) -> None:
    """Raise ``SystemExit`` naming the ESPNet-only flags set beside
    ``--segformer_checkpoint`` (the JAX package's message), then naming
    every flag set to a value whose machinery the port does not have."""
    if args.segformer_checkpoint:
        # the ESPNet-ensemble-only flags have no effect on the SegFormer
        # path: name the conflicting ones instead of ignoring them
        ignored = [name for name, val, default in (
            ("--segmentation_weights_dir", args.segmentation_weights_dir,
             None),
            ("--folds", tuple(args.folds), (1, 2, 3, 4, 5)),
            ("--engine", args.engine, "auto"),
            ("--precision", args.precision, "default"),
            ("--transfer", args.transfer, "auto"),
            ("--host_resize", args.host_resize, False),
            ("--pack_output", args.pack_output, False),
            ("--fold_parallel", args.fold_parallel, 0),
        ) if val != default]
        if ignored:
            raise SystemExit(
                "these flags apply only to the 5-fold ESPNet ensemble "
                "and conflict with --segformer_checkpoint: "
                + ", ".join(ignored))
    unported = [name for name, val, default in (
        ("--data_parallel", args.data_parallel, 0),
        ("--fold_parallel", args.fold_parallel, 0),
        ("--host_resize", args.host_resize, False),
        ("--pack_output", args.pack_output, False),
    ) if val != default]
    if args.engine == "xla":
        unported.append("--engine xla")
    if unported:
        raise SystemExit("not ported: " + ", ".join(unported))


def resolve_mesh_policy(args, n_devices: int) -> None:
    """``--mesh auto`` (default) resolves a fold x data mesh on a host with
    more than one card when no layout flag and no explicit engine is given;
    the port has no mesh, so that case raises.  One card resolves to no
    mesh, as in the JAX package."""
    if (args.mesh == "auto" and n_devices > 1 and args.engine == "auto"
            and not (args.fold_parallel or args.data_parallel
                     or args.segformer_checkpoint)):
        raise SystemExit(f"--mesh auto on {n_devices} cards: the fold x data "
                         "mesh is not ported; pass --mesh off")


def resolve_slide_pipeline(args) -> bool:
    """The --slide_pipeline policy: 'auto' enables the three-stage
    cross-slide overlap only on hosts with >= 2 usable CPU cores -- with a
    single core the producer/emitter host work (window decode, overlay
    decode and encode) contends with the device-dispatch thread."""
    if getattr(args, "serial_slides", False):
        return False
    mode = getattr(args, "slide_pipeline", "auto")
    if mode == "auto":
        # usable cores, not host cores: a cpuset-pinned container on a
        # big node must count as single-core here
        try:
            cores = len(os.sched_getaffinity(0))
        except AttributeError:  # non-Linux
            cores = os.cpu_count() or 1
        return cores >= 2
    return mode == "on"


def build_pipeline(args, backend, device="cuda"):
    """Flags -> :class:`..pipeline.e2e.FusedEndToEnd` on ``device`` for
    either model family: the 5-fold ESPNet ensemble, or SegFormer/GTCS with
    ``--segformer_checkpoint``.  Shared with ``gseg-serve``."""
    from ..pipeline.e2e import FusedEndToEnd
    from ..pipeline.fused import EnsembleConfig, EnsembleSegmenter

    check_ported(args)
    if args.segformer_checkpoint:
        from ..palette import GTCS_PALETTE
        from ..pipeline.fused_segformer import (SegformerSlideConfig,
                                                SegformerSlideSegmenter,
                                                load_segformer_checkpoint)

        state_dict, ckpt_labels = load_segformer_checkpoint(
            args.segformer_checkpoint)
        segmenter = SegformerSlideSegmenter(
            state_dict, SegformerSlideConfig(
                num_labels=args.num_labels or ckpt_labels,
                input_size=args.input_size,
                batch_size=args.seg_batch_size), device=device)
        return FusedEndToEnd(
            backend, data_category=args.data_category,
            window_size=args.window_size, overlap_ratio=args.overlap_ratio,
            detect_conf=args.conf_threshold,
            merge_conf=args.merge_conf_threshold,
            merge_overlap=args.merge_overlap_threshold,
            segmenter=segmenter, palette=GTCS_PALETTE, crop_artifact="png")
    if not args.segmentation_weights_dir:
        raise SystemExit("--segmentation_weights_dir is required "
                         "unless --segformer_checkpoint is given")
    ckpts = [os.path.join(args.segmentation_weights_dir,
                          f"espnet_fold{k}.pth") for k in args.folds]
    ensemble = EnsembleSegmenter(
        EnsembleConfig(checkpoints=ckpts, folds=tuple(args.folds),
                       batch_size=args.seg_batch_size,
                       precision=args.precision,
                       pack_output=args.pack_output),
        engine=args.engine, device=device)
    return FusedEndToEnd(
        backend, ensemble, data_category=args.data_category,
        window_size=args.window_size, overlap_ratio=args.overlap_ratio,
        detect_conf=args.conf_threshold,
        merge_conf=args.merge_conf_threshold,
        merge_overlap=args.merge_overlap_threshold,
        host_resize=args.host_resize, transfer=args.transfer)


def main(argv=None, device="cuda"):
    """``device="cpu"`` runs every model on the CPU (for tests)."""
    args = build_parser().parse_args(argv)
    from ..pipeline.e2e import FusedEndToEnd
    from ..utils.glomus_handler import GlomusHandler
    from ..utils.target_list import read_target_list
    from .detect import load_backend

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

    staining_dir = GlomusHandler.get_staining_type(args.data_category)
    json_dir = (None if args.no_json
                else args.json_dir or os.path.join(args.output_dir, "json"))
    completed = FusedEndToEnd.prepare_output(
        args.output_dir, args.data_category, resume=args.resume)
    jobs = []
    for entry in read_target_list(args.target_list):
        if entry.is_comment:
            continue
        if entry.specimen_id in completed:
            print(f"skip {entry.specimen_id} (already processed)")
            continue
        target_dir = os.path.join(args.data_dir, staining_dir,
                                  entry.specimen_id)
        if not os.path.isdir(target_dir):
            continue
        for candidate in sorted(os.listdir(target_dir)):
            body, ext = os.path.splitext(candidate)
            if entry.file_name.find(body) < 0 or ext.lower() not in (
                    ".ndpi", ".tiff", ".tif", ".svs"):
                continue
            jobs.append((os.path.join(target_dir, candidate),
                         entry.specimen_id))
            break
    # cross-slide pipelining: detection of slide N+1 / segmentation of N /
    # emission of N-1 stream on three threads (pipeline/e2e.py run_slides);
    # a failing slide aborts the run after the in-flight work drains
    pipe.run_slides(jobs, args.output_dir, json_dir=json_dir,
                    write_overlay=not args.no_overlay, progress=True,
                    pipeline=resolve_slide_pipeline(args))


if __name__ == "__main__":
    main()
