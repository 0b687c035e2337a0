"""CLI: whole-slide glomerulus detection (``gseg-detect``) on the GPU.

    python -m glomeruli_segmentation_tpu_torch.cli.detect --model DIR \
        --target_list LIST --data_dir DIR --staining OPT_PAS

Counterpart of ``glomeruli_segmentation_tpu/cli/detect.py``, with the same
flags and defaults (``--staining`` defaults to ``OPT_PAM`` and
``--conf_threshold`` to 0.6 here, unlike ``gseg-e2e``).  It writes
``<output_dir>/<staining><ext>.csv`` and its ``_log.csv`` through
:meth:`..pipeline.detect.GlomusDetector.split_all`; ``--resume`` skips the
slides the timing log holds.  ``--model`` is a directory holding
``detector.ckpt.pth``, ``od_api_detector.ckpt.pth`` or the reference's
``frozen_inference_graph.pb`` (:func:`load_backend`, shared with the other
commands).  ``--data_parallel N`` splits each window batch over N devices
(``-1``: all visible cards); ``main(argv, device, devices)`` takes the
mesh's devices (for tests N logical ``cpu`` devices).
"""
import argparse
import os


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description="Load RoI")
    parser.add_argument("--model", type=str, required=True,
                        help="model directory")
    parser.add_argument("--target_list", type=str, required=True)
    parser.add_argument("--data_dir", type=str, required=True)
    parser.add_argument("--staining", dest="data_category", type=str,
                        default="OPT_PAM")
    parser.add_argument("--output_dir", type=str, default="./output")
    parser.add_argument("--output_file_ext", type=str, default="_GlomusList")
    parser.add_argument("--window_size", type=int, default=None)
    parser.add_argument("--overlap_ratio", type=float, default=None)
    parser.add_argument("--conf_threshold", type=float, default=0.6)
    parser.add_argument("--model_name", default=None,
                        help="detector file inside --model. Default: "
                             "auto-discover (detector.ckpt.pth > "
                             "od_api_detector.ckpt.pth > "
                             "frozen_inference_graph.pb); naming a file "
                             "explicitly loads exactly that file")
    parser.add_argument("--batch_size", type=int, default=8)
    parser.add_argument("--resume", action="store_true",
                        help="skip slides already present in the timing log "
                             "and append to existing outputs")
    # OD-API post-processing knobs (frozen-graph path only; defaults match
    # the OD-API sample faster_rcnn_inception_v2 pipeline config)
    parser.add_argument("--min_dimension", type=int, default=600,
                        help="keep_aspect_ratio_resizer min dimension")
    parser.add_argument("--max_dimension", type=int, default=1024,
                        help="keep_aspect_ratio_resizer max dimension")
    parser.add_argument("--max_proposals", type=int, default=300,
                        help="first-stage max proposals")
    parser.add_argument("--device_resize", action="store_true",
                        help="resize windows on the card after the upload "
                             "(frozen-graph backend)")
    parser.add_argument("--cv2_resize", action="store_true",
                        help="cv2 half-pixel keep-aspect resize instead of "
                             "the frozen graph's TF1 scale*i sampling")
    parser.add_argument("--data_parallel", type=int, default=0,
                        help="shard window batches over an N-device mesh "
                             "(0 = single device, -1 = all devices); "
                             "batch_size must be a multiple of N")
    return parser


def load_backend(model_dir: str, model_name: str = None, batch_size: int = 8,
                 od_api_overrides=None, data_parallel: int = 0,
                 device="cuda", devices=None):
    """Resolve a detector backend from ``model_dir``.

    ``model_name=None`` auto-discovers in precedence order native checkpoint
    (``detector.ckpt.pth``) > fine-tuned OD-API checkpoint
    (``od_api_detector.ckpt.pth``) > ``frozen_inference_graph.pb``.  An
    explicit ``model_name`` loads exactly that file (dispatch by basename),
    so a fine-tuned checkpoint written next to the downloaded ``.pb`` cannot
    silently preempt an explicitly requested graph.  ``data_parallel`` and
    ``devices``: the backend's window mesh (``pipeline/detect.py``)."""
    mesh = {"data_parallel": data_parallel, "devices": devices}
    explicit = model_name is not None
    if explicit:
        requested = os.path.join(model_dir, model_name)
        if not os.path.isfile(requested):
            raise SystemExit(f"--model_name: {requested} not found")
        base = os.path.basename(model_name)
        native_ok = base == "detector.ckpt.pth"
        od_ok = base == "od_api_detector.ckpt.pth"
        pb_ok = not (native_ok or od_ok)
    else:
        native_ok = od_ok = pb_ok = True
        model_name = "frozen_inference_graph.pb"

    # an explicit name loads exactly the file named -- including when it
    # lives in a subdirectory of model_dir (dispatch is by basename only)
    native_ckpt = (requested if explicit
                   else os.path.join(model_dir, "detector.ckpt.pth"))
    if native_ok and os.path.isfile(native_ckpt):
        from ..convert.detector_import import load_detector_checkpoint
        from ..pipeline.detect import TorchDetectorBackend

        state, config = load_detector_checkpoint(native_ckpt)
        return TorchDetectorBackend(state, config, batch_size, device=device,
                                    **mesh)

    od_ckpt = (requested if explicit
               else os.path.join(model_dir, "od_api_detector.ckpt.pth"))
    if od_ok and os.path.isfile(od_ckpt):
        # natively fine-tuned OD-API weights; architecture constants saved
        # at training time are defaults, CLI overrides win
        from ..convert.pb_import import load_od_api_checkpoint
        from ..pipeline.detect import ODAPIDetectorBackend

        params, num_classes, saved = load_od_api_checkpoint(od_ckpt)
        arch_keys = ("stride", "anchor_scales", "anchor_aspects",
                     "anchor_base", "initial_crop_size")
        merged = {k: tuple(v) if isinstance(v, list) else v
                  for k, v in saved.items() if k in arch_keys}
        merged.update(od_api_overrides or {})
        return ODAPIDetectorBackend(params=params, num_classes=num_classes,
                                    batch_size=batch_size, device=device,
                                    **mesh, **merged)

    pb_path = os.path.join(model_dir, model_name)
    if pb_ok and os.path.isfile(pb_path):
        # the reference's downloaded OD-API export: constants are extracted
        # and assembled into the native inception_v2 Faster R-CNN
        from ..convert.pb_import import UnmappedWeightsError
        from ..pipeline.detect import ODAPIDetectorBackend

        try:
            return ODAPIDetectorBackend(pb_path, batch_size, device=device,
                                        **mesh, **(od_api_overrides or {}))
        except UnmappedWeightsError as e:
            raise SystemExit(
                f"{pb_path}: not an OD-API inception_v2 Faster R-CNN "
                f"export ({e}); train/convert a native detector checkpoint "
                "(detector.ckpt.pth) instead")
    raise SystemExit(f"no detector model found in {model_dir}")


def main(argv=None, device="cuda", devices=None):
    """``device="cpu"`` runs the detector on the CPU (for tests);
    ``devices`` are the window mesh's under ``--data_parallel``."""
    args = build_parser().parse_args(argv)
    from ..pipeline.detect import GlomusDetector

    backend = load_backend(
        args.model, args.model_name, args.batch_size,
        od_api_overrides={"min_dimension": args.min_dimension,
                          "max_dimension": args.max_dimension,
                          "max_proposals": args.max_proposals,
                          "device_resize": args.device_resize,
                          "compat_tf1_resize": not args.cv2_resize},
        data_parallel=args.data_parallel, device=device, devices=devices)
    detector = GlomusDetector(args.data_category, args.target_list,
                              args.data_dir, args.output_dir,
                              args.output_file_ext, args.window_size,
                              args.overlap_ratio, args.conf_threshold,
                              args.batch_size, resume=args.resume)
    detector.split_all(backend)


if __name__ == "__main__":
    main()
