"""CLI: per-crop glomerular segmentation (``gseg-segment``) on the GPU.

    python -m glomeruli_segmentation_tpu_torch.cli.segment \
        --rgb_data_dir DIR --weights PTH --mean B G R --std B G R \
        [--label_data_dir DIR] [--engine fused]

Counterpart of ``glomeruli_segmentation_tpu/cli/segment.py``, with the same
flags and defaults: the public flag surface of
``module/espnet/test/VisualizeResults_iou.py:292-321`` plus ``--batch_size``,
``--skip_existing``, ``--fast``, ``--precision`` and ``--engine``.
``--engine fused`` runs the level-3 ESP blocks through K1; ``--precision``
``highest`` and ``high`` keep TF32 off, ``default`` turns it on.
``--gpu_id`` is accepted and ignored.  ``--data_parallel N`` splits each
crop batch over N devices (the ``xla`` engine only; ``-1``: all visible
cards), ``--pack_output`` packs the class-map readback 3 px/byte.
``main(argv, device="cuda")`` runs on the card and raises without one;
``device="cpu"`` runs on the CPU, and ``devices`` gives the mesh's devices
(for tests: N logical ``cpu`` devices).
"""
from argparse import ArgumentParser

from ..pipeline.segment import run_segment


def build_parser() -> ArgumentParser:
    parser = ArgumentParser(
        description="Glomerular segmentation on the cropped images")
    parser.add_argument("--rgb_data_dir", required=True,
                        help="Parent directory of original glomerular images")
    parser.add_argument("--label_data_dir", default=None,
                        help="Parent directory of label images (optional)")
    parser.add_argument("--img_extn", default="PNG")
    parser.add_argument("--inWidth", type=int, default=1024)
    parser.add_argument("--inHeight", type=int, default=512)
    parser.add_argument("--scaleIn", type=int, default=1,
                        help="8 for ESPNet-C, 1 for ESPNet")
    parser.add_argument("--modelType", type=int, default=1,
                        help="1=ESPNet, 2=ESPNet-C")
    parser.add_argument("--savedir", default="./results")
    parser.add_argument("--gpu_id", default=-1, type=int,
                        help="kept for reference CLI compatibility; "
                             "ignored")
    parser.add_argument("--decoder", action="store_true")
    parser.add_argument("--weights", required=True)
    parser.add_argument("--mean", required=True, nargs="*",
                        help="global BGR mean of training images")
    parser.add_argument("--std", required=True, nargs="*",
                        help="global BGR std of training images")
    parser.add_argument("--p", default=2, type=int)
    parser.add_argument("--q", default=8, type=int)
    parser.add_argument("--cityFormat", action="store_true")
    parser.add_argument("--colored", action="store_true")
    parser.add_argument("--overlay", action="store_true")
    parser.add_argument("--classes", default=5, type=int)
    parser.add_argument("--json_image_data", default="org",
                        choices=["org", "classmap"],
                        help="'org' embeds the original crop in the labelme "
                             "JSON (VisualizeResults_iou.py behaviour); "
                             "'classmap' embeds the relabeled class map the "
                             "WSI evaluator expects "
                             "(VisualizeResults_iou_pixel.py behaviour)")
    # extras beyond the reference's flags
    parser.add_argument("--batch_size", default=8, type=int)
    parser.add_argument("--skip_existing", action="store_true",
                        help="resume: skip crops whose output JSON exists. "
                             "Note: summary CSVs are rewritten and cover "
                             "only the crops processed in this run")
    parser.add_argument("--fast", action="store_true",
                        help="fused on-device preprocessing")
    parser.add_argument("--precision", default="highest",
                        choices=["default", "high", "highest"],
                        help="'highest' and 'high' keep TF32 off (the fp32 "
                             "reference); 'default' turns TF32 on")
    parser.add_argument("--engine", default="xla", choices=["xla", "fused"],
                        help="'fused' runs the level-3 ESP blocks through "
                             "the fused kernel; 'xla' is the plain model")
    parser.add_argument("--data_parallel", type=int, default=0,
                        help="split crop batches over an N-device mesh "
                             "(0 = one device, -1 = all devices); "
                             "batch_size must be a multiple of N")
    parser.add_argument("--pack_output", action="store_true",
                        help="pack class-map readbacks 3 px/byte (base-"
                             "classes) before the device->host copy; exact")
    return parser


def main(argv=None, device="cuda", devices=None):
    args = build_parser().parse_args(argv)
    if args.overlay:
        args.colored = True
    run_segment(args, device=device, devices=devices)


if __name__ == "__main__":
    main()
