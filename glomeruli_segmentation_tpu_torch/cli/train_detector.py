"""CLI: train the whole-slide glomerulus detector (``gseg-train-detector``)
on the GPU.

    python -m glomeruli_segmentation_tpu_torch.cli.train_detector \
        --data_dir DIR --target_list LIST --output_dir MODEL_DIR
    python -m glomeruli_segmentation_tpu_torch.cli.train_detector \
        --data_dir DIR --target_list LIST --output_dir MODEL_DIR \
        --finetune_pb frozen_inference_graph.pb

Counterpart of ``glomeruli_segmentation_tpu/cli/train_detector.py``, with
the same flags and defaults, plus ``--device`` (default ``cuda``, which
raises without a card; ``cpu`` runs on the CPU).  It reads the annotated
slide layout ``make_seg_data`` reads, ``<data_dir>/<staining_dir>/
<patient>/{*.ndpi, annotations/*.xml}``, and writes ``detector.ckpt.pth``
(the native ResNet-50-C4 or tiny Faster R-CNN) or, with ``--finetune_pb``,
``od_api_detector.ckpt.pth`` into ``--output_dir``; both packages'
``gseg-detect`` load either.  ``--data_parallel N`` splits the window
batch over N ranks, one process per card (``parallel/distributed.py``;
under ``--device cpu`` every rank runs on the CPU); the batch must divide.
"""
import argparse


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description="Train glomerulus detector")
    parser.add_argument("--staining", default="OPT_PAS")
    parser.add_argument("--data_dir", required=True)
    parser.add_argument("--target_list", required=True)
    parser.add_argument("--output_dir", required=True)
    parser.add_argument("--steps", type=int, default=2000)
    parser.add_argument("--batch_size", type=int, default=4)
    parser.add_argument("--lr", type=float, default=1e-3)
    parser.add_argument("--image_size", type=int, default=512)
    parser.add_argument("--backbone", default="resnet50",
                        choices=["resnet50", "tiny"])
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--bf16", action="store_true",
                        help="bfloat16 autocast of the native detector's "
                             "forward; parameters, BN statistics, box math "
                             "and the loss stay float32 (default: full "
                             "float32, TF32 off)")
    parser.add_argument("--data_parallel", type=int, default=0,
                        help="shard window batches over an N-device mesh "
                             "(0 = off, -1 = all devices); params and "
                             "optimizer state replicate")
    parser.add_argument("--finetune_pb", default=None,
                        help="fine-tune the reference's downloaded OD-API "
                             "frozen graph (frozen_inference_graph.pb) "
                             "instead of training the native detector; "
                             "saves od_api_detector.ckpt.pth")
    parser.add_argument("--device", default="cuda",
                        help="cuda (default; raises without a card) or cpu")
    return parser


def main(argv=None, device=None, devices=None) -> str:
    """Train; returns the checkpoint's path.  ``device`` overrides
    ``--device``; ``devices`` lists the ranks' devices."""
    args = build_parser().parse_args(argv)
    device = device if device is not None else args.device
    from ..models.faster_rcnn import FasterRCNNConfig
    from ..train.detector_driver import DetectorTrainConfig, train_detector

    config = DetectorTrainConfig(
        image_size=args.image_size, batch_size=args.batch_size,
        steps=args.steps, lr=args.lr, seed=args.seed)
    if args.finetune_pb:
        from ..train.od_api_finetune import finetune_od_api

        path = finetune_od_api(args.staining, args.data_dir,
                               args.target_list, args.output_dir, config,
                               pb_path=args.finetune_pb,
                               data_parallel=args.data_parallel,
                               device=device, devices=devices)
        print(f"saved {path}")
        return path
    model_config = FasterRCNNConfig(
        image_size=(args.image_size, args.image_size),
        backbone=args.backbone)
    path = train_detector(args.staining, args.data_dir, args.target_list,
                          args.output_dir, config, model_config,
                          data_parallel=args.data_parallel, bf16=args.bf16,
                          device=device, devices=devices)
    print(f"saved {path}")
    return path


if __name__ == "__main__":
    main()
