"""Smoke run of the PyTorch/CUDA port on one GPU.

    python3 chip_smoke.py

1. prints the card (``nvidia-smi`` name and power limit), the torch and
   CUDA versions and both TF32 switches;
2. builds every kernel of the port from ``glomeruli_segmentation_tpu_torch/
   csrc`` (one ``nvcc`` per source, all at once) into build/torch_kernels/,
   and the native slide reader (``wsi/native/ndpi_reader.cc``, ``g++``)
   into build/native_reader/, with which every phase opens its slides;
3. holds K1 (the fused ESP block) and K2 (the ESP block on the padded
   layout over the packed engine's 5 folds, with zero halo columns and pad
   channels checked) against their plain PyTorch versions at the main
   paths' shapes, in float32 with TF32 off and in bfloat16, and times both
   (TFLOP/s and share of the bound; K2's bound also with the dense
   block-diagonal product count); holds both against their plain versions
   at the edges of their tiling too (K2 also at two folds), and counts
   the tensor-core (HMMA/HGMMA) instructions of each K1 and K2 kernel with
   ``cuobjdump -sass`` where the toolkit has it;
4. drives the main path at full width -- the 5-fold ESPNet slide segmenter
   (5 classes, p=2, q=8, 512x1024 network input, crop batch 32, bf16) on
   a seeded synthetic slide with random seeded weights -- with the kernel
   launch counts set to 0 just before and read just after, first with the
   ``fused`` engine, then with the fold-packed ``packed`` engine (what
   ``engine="auto"`` picks at batch 32), with its plain level 2 and with
   K2 in turns (``fuse_level2``), and with a plain level 3 (no K1), in
   turns with the fused engine, each packed form traced, and times the
   engine's own plain level-2 block at K2's shape (K2's composed-ops
   reference); then
   runs the f32 "highest" paths with and without each kernel, and the
   fused model against the plain ``nn.Module`` ESPNet on a small input;
5. holds K3 (greedy NMS) against ``nms_plain`` at both of the detector's
   NMS shapes, on seeded boxes with tied scores and on the real proposals
   of one window batch, and on seeded boxes at N = 6000 and 8192 (indices
   and counts must be equal), and times both by events (the kernel's
   device time in a trace beside it);
6. drives the second path at full width -- the ResNet-50-C4 Faster R-CNN
   window detector (``FasterRCNNConfig()``, bf16, random seeded weights
   with calibrated BN statistics) over a seeded level-3 pyramid stub at
   the e2e operating point (2000 um windows, overlap 0.1, 0.2265 um/px,
   1104x1104 px windows, batch 8: 20 windows in 3 batches) -- with the K3
   count set to 0 just before and read just after; checks the detection
   output contract; compares the scan with the plain NMS in turns; then
   runs one f32 batch (TF32 off) with and without the kernel, which must
   agree exactly, and traces one bf16 batch;
7. drives the frozen-graph detector the same way -- the OD-API inception_v2
   Faster R-CNN (``ODAPIDetectorBackend`` on ``random_od_api_consts(0)``:
   the published slim widths, BN statistics calibrated on the card, bf16,
   the host TF1 resize of each 1104-px window to 600x600) over the same
   stub: K3 against ``nms_plain`` on one batch's real (8, 6000 -> 300)
   RPN and (8, 300 -> 100) second-stage problems; the timed scan (6 K3
   launches, output contract, host resize ms per batch); the scan with
   the plain NMS and with ``device_resize=True`` in turns with it; the cv2
   resize (``compat_tf1_resize=False``), which must raise where cv2 is
   missing; one f32 batch with and without K3 (identical); a traced batch;
   and holds the event-based readback of one batch, read after the next
   batch is launched, to a plain ``.cpu()`` copy;
8. drives the end-to-end pipeline (``gseg-e2e``) at full width through
   ``cli/e2e.py``'s ``build_pipeline`` at the CLI's defaults (the OD-API
   detector on ``random_od_api_consts(E2E_DETECTOR_SEED)`` with the host
   TF1 resize, the packed ensemble at crop batch 32, bf16) over a
   35328x26496 pyramidal TIFF written by the port's ``wsi/synthetic.py``
   and read by its ``open_slide``, which must give the native reader (no
   read of this or a later path goes through the Python reader): two jobs
   pipelined and serial (merged
   CSV, labelme JSONs and overlays byte-identical, canvases background
   outside the boxes, at least one full crop batch), with the K1 and K3
   counts set to 0 before the pipelined run and read after it, the serial
   run traced; then one slide with ``--no_json``, and one with
   ``--no_json --device_resize``, with host spans (reads, resize,
   packing, JSONs, overlay) per run;
9. writes the e2e detector's parameters as ``od_api_detector.ckpt.pth``
   into a model directory, so that the commands below load it through
   ``cli/detect.load_backend``, and runs the staged detect stage on the
   e2e slide: ``gseg-detect`` (``cli/detect.main`` at the e2e operating
   point; K3 launches 2 a window batch, the detections the e2e phase's,
   ``--resume`` leaving the CSV and the timing log byte-identical) and
   ``gseg-merge`` (``cli/merge.main`` at 0.9 / 0.35: the e2e phase's
   merged boxes);
10. runs the staged segment-and-evaluate chain on a written GT slide
    (12288x9216 px at 0.2265 um/px, 32 glomeruli of radius 320 to 520 px,
    a Pascal-VOC XML, labelme GT JSONs, a detection CSV of the GT boxes
    grown by 8 px and two false positives) through the port's commands:
    ``gseg-merge`` (0.9 / 0.35), ``gseg-make-seg-data`` in GT mode (recall
    1.0, one crop and one label per merged box), ``gseg-segment`` with the
    e2e phase's fold-1 checkpoint at the command's defaults (f32, TF32
    off, batch 8) with ``--engine fused`` (K1 launches 8 a batch) and then
    ``--engine xla`` (none), the count set to 0 before and read after each
    (class maps of the two equal on >= 0.999 of pixels, pixel counts
    summing to each crop's area), and ``gseg-eval-wsi`` in GT mode (one
    slide row and a total row with a finite mIoU); before the chain, K1
    against its plain version at the command's shape (8, 64, 128, 128) in
    f32; stage seconds, crops/s, host spans and peak memory per engine;
11. runs ``gseg-warmup`` (``python -m ...cli.warmup``, flat transfer, the
    1104-px window) in a fresh process with the kernels already built: exit
    code 0, its ``warmed:`` line, its wall time and line times;
12. runs ``gseg-serve`` (``cli/serve.main``) in this process with
    ``--no_json`` at the CLI's other defaults over four tickets (two
    patients on the e2e slide, a second ticket for the first, a missing
    slide), with the K1, K2 and K3 counts set to 0 before and read after:
    the spool's ``done/``, ``failed/`` and ``active/``, the log rows, the
    merged rows and overlay byte-identical to the e2e ``--no_json`` run's,
    the launches, per-ticket times, the server's start, host RSS and
    device memory;
13. runs the SegFormer/GTCS model family at the published MiT widths on
    seeded port-initialised weights: mit-b0 and mit-b4 written as the
    trainer's ``flax_model.pth`` and read back (both geometries recovered
    from the state dict), the b0 forward on the card against the same
    module on the CPU at (8, 512, 512, 3) in float32 with TF32 off (logits
    within 1e-3, argmax agreeing on >= 0.999 of pixels), ms per batch by
    CUDA events, crops/s, TFLOP/s and peak memory for b0 at batch 32 and
    b4 at batch 8 in float32 and bf16, the bf16-vs-f32 argmax agreement,
    and a traced b0 batch by operator group;
14. runs ``gseg-e2e --segformer_checkpoint`` (``cli/e2e.main``) with the b0
    checkpoint, the e2e phase's OD-API detector and slide, once with
    ``--no_json`` (the device gather) and once writing the label PNGs, with
    the K1, K2 and K3 counts set to 0 before and read after each: (0, 0, 6)
    per slide, one mode-'L' PNG of each merged box's size with values
    below 5, the two canvases byte-identical, the merged CSV the ESPNet e2e
    phase's, the overlay written; s/slide, host spans and peak memory;
15. runs the staged GTCS chain on the staged segment phase's GT slide: the
    crops over their 20 um margin frames and GTCS label PNGs in the JAX
    package's fixture layout, two mit-b4 checkpoints and a ``log.txt``,
    ``gseg-segformer-test --save_image 1`` (the checkpoint ``log.txt``
    names, one row per crop with pixel counts summing to its label's area,
    a finite mIoU) and ``gseg-eval-wsi-gtcs --evaluate`` on its ``seg/``
    and, as a control, on the GT labels (a 7-field total row; the
    control's accuracy above 0.999);
16. holds the native slide reader to the Python one on the main path's
    crops at level 0 (every merged box of the e2e slide's first job, and
    the GT slide's 32 glomerulus crops over their 20 um margin frames):
    equal bytes for every crop, seconds and MP/s per reader, and for the
    e2e crops a read from 4 threads with each reader;
17. runs ``gseg-selftest`` (``cli/selftest.main``) on the e2e slide and the
    e2e detector's constants written as a frozen graph with
    ``tests/pb_graph_writer.py``, the K3 count set to 0 before and read
    after: an ``ok`` verdict, the slide checked by both readers, the graph
    parsed back to the detector's parameter count, K3 launched twice (one
    window: (1, 6000 -> 300) and (1, 300 -> 100)), and K3 against its plain
    version on that window's own two B = 1 problems; then checks that no
    slide of the run was opened with the Python reader;
18. trains: ``gseg-train`` (``cli/train.main``) on a written synthetic
    dataset (48 training and 12 validation 1024x512 PAS-like crops with
    palette labels in 0..4, listed by ``gseg-create-dataset-txt``) at the
    reference recipe (ESPNet p=2, q=8, 5 classes, batch 8, one epoch over
    the five scales and the validation set), first the encoder, then the
    decoder from the encoder's ``model_1.pth``: every artifact written, the
    weights loading with ``strict=True``, every loss finite, and per scale
    s/step at steady state (the first step of each shape left out),
    images/s, the loader-wait share and the peak memory; one f32 decoder
    step at 512x1024, batch 2, on the card and on the CPU from equal
    state, twice (loss, gradients, BN statistics and parameters within
    ``TRAIN_PARITY``); f32 and bf16 steps at the main scale (1024x512,
    batch 10): s/step and the losses within 5e-2; ``gseg-segformer-train``
    (``cli/segformer_train.main``) with mit-b0 from a backbone-only
    ``model.safetensors`` of seeded weights over a written GTCS tree,
    batch 2, accumulation 2, two epochs: the adopted tensors, ``log.txt``,
    the checkpoints kept, the newest read back by ``gseg-segformer-test``'s
    loader, s/step; the K1, K2 and K3 counts over the phase (0: the JAX
    trainers reach no kernel either), recorded, not assumed;
19. trains the detectors on the staged segment phase's GT slide tree
    (512x512 windows at ds8, batch 4, lr 1e-3): ``gseg-train-detector``
    (``cli/train_detector.main``) for the native ResNet-50-C4 Faster R-CNN,
    30 steps in f32 and 20 in ``--bf16``, and ``--finetune_pb`` on the e2e
    detector's constants written as a frozen graph, 20 steps (64
    proposals), each run with the K3 count set to 0 just before and read
    just after (one launch a step), every loss finite, s/step at steady
    state, the window sampler's share and the peak memory; K3 against
    ``nms_plain`` on the real RPN problems of a training batch, (4, 2000
    -> 300) and (4, 6000 -> 64) at IoU 0.7; one f32 step with and without
    K3 from equal state (proposals bitwise equal, losses within 1e-6); the
    card's f32 step against the CPU's (ResNet-50-C4, 512x512, batch 1:
    losses, gradients and BN statistics within ``TRAIN_PARITY``, on the
    CPU's proposals where the two devices' differ, with the share of equal
    proposals); each checkpoint through ``cli/detect.load_backend``
    detecting a window batch on the card;
20. prints one JSON line of kernel results (K3 once per detector, each with
    its launches in the e2e run and in the server run, the OD-API one also
    in the SegFormer e2e run and in ``gseg-selftest``, and the selftest
    window's two cases among its ``cases``; K1 and K2 with their
    launches there too, 0; K1 also with its launches in the staged fused
    segment run and its f32 case there; each with its launches in the
    training phase; K3 also with its launches in the detector training
    phase and its training-shape case among its ``cases``) and, last, one
    JSON status line.

Any failed check raises, so the exit code is non-zero and the status line
is not printed.  It needs a CUDA card and exits non-zero without one.
``python3 chip_smoke.py --only detector_training`` builds and runs phase
19 alone (on a tree it writes), without the result lines.
"""
from __future__ import annotations

import concurrent.futures
import contextlib
import copy
import importlib.util
import io
import json
import math
import os
import re
import shutil
import struct
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import torch

from glomeruli_segmentation_tpu_torch import read_host, readback, tf32
from glomeruli_segmentation_tpu_torch import wsi
from glomeruli_segmentation_tpu_torch.cli import detect as detect_cli
from glomeruli_segmentation_tpu_torch.cli import e2e as e2e_cli
from glomeruli_segmentation_tpu_torch.cli import eval_wsi as eval_wsi_cli
from glomeruli_segmentation_tpu_torch.cli import make_seg_data as seg_data_cli
from glomeruli_segmentation_tpu_torch.cli import merge as merge_cli
from glomeruli_segmentation_tpu_torch.cli import segment as segment_cli
from glomeruli_segmentation_tpu_torch.cli import selftest as selftest_cli
from glomeruli_segmentation_tpu_torch.cli import serve as serve_cli
from glomeruli_segmentation_tpu_torch.cli.e2e import (
    build_parser,
    build_pipeline,
    resolve_slide_pipeline,
)
from glomeruli_segmentation_tpu_torch.convert.detector_import import (
    random_detector_state,
)
from glomeruli_segmentation_tpu_torch.convert.espnet_import import (
    load_espnet_state_dict,
    random_state_dict,
)
from glomeruli_segmentation_tpu_torch.convert.pb_import import (
    random_od_api_consts,
)
from glomeruli_segmentation_tpu_torch.convert.segformer_import import (
    save_flax_checkpoint,
)
from glomeruli_segmentation_tpu_torch.models.faster_rcnn import (
    FasterRCNNConfig,
    build_anchors,
)
from glomeruli_segmentation_tpu_torch.models.espnet import create_espnet
from glomeruli_segmentation_tpu_torch.models.segformer import (
    Segformer,
    SegformerConfig,
    config_from_state_dict,
    random_segformer_state_dict,
)
from glomeruli_segmentation_tpu_torch.models.espnet_fused import FusedESPNet
from glomeruli_segmentation_tpu_torch.models.espnet_packed import (
    PackedEnsembleESPNet,
    _esp_fused_operands,
    _esp_plain,
)
from glomeruli_segmentation_tpu_torch.ops import _build
from glomeruli_segmentation_tpu_torch.ops.esp_block import (
    HALO,
    esp_block_fused,
    esp_block_padded,
    esp_block_padded_plain,
    esp_block_plain,
    esp_group_channels,
    esp_pad_io,
    pack_esp_weights,
    unpack_esp_groups,
)
from glomeruli_segmentation_tpu_torch.ops.nms import nms, nms_plain, premask
from glomeruli_segmentation_tpu_torch.pipeline import e2e as e2e_module
from glomeruli_segmentation_tpu_torch.pipeline import fused as fused_module
from glomeruli_segmentation_tpu_torch.pipeline import seg_data as seg_data_module
from glomeruli_segmentation_tpu_torch.pipeline import segment as segment_module
from glomeruli_segmentation_tpu_torch.pipeline import serve as serve_module
from glomeruli_segmentation_tpu_torch.pipeline.detect import (
    GlomusDetector,
    ODAPIDetectorBackend,
    TorchDetectorBackend,
    pack_detections,
)
from glomeruli_segmentation_tpu_torch.pipeline.e2e import FusedEndToEnd
from glomeruli_segmentation_tpu_torch.pipeline.fused import (
    FOLD_NORMALIZATION,
    EnsembleConfig,
    EnsembleSegmenter,
    FusedSlideSegmenter,
)
from glomeruli_segmentation_tpu_torch.pipeline.selftest import _leaves
from glomeruli_segmentation_tpu_torch.utils.labelme_io import (
    img_arr_to_b64,
    img_b64_to_arr,
    lblsave,
)
from glomeruli_segmentation_tpu_torch.wsi import native_reader
from glomeruli_segmentation_tpu_torch.wsi.native import _build as reader_build
from glomeruli_segmentation_tpu_torch.wsi.native_reader import NativeSlide
from glomeruli_segmentation_tpu_torch.wsi.synthetic import (
    pas_like_image,
    write_pyramidal_tiff,
)
from glomeruli_segmentation_tpu_torch.wsi.tiff_reader import Slide

ROOT = Path(__file__).resolve().parent
WORK = ROOT / "build" / "chip_smoke"
# H100 SXM data-sheet peaks (dense): HBM bytes/s, and operations/s by type
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {torch.bfloat16: 989e12, torch.float32: 67e12}
# |kernel - plain| <= atol + rtol * |plain|, per type.  f32: the same f32
# products summed in another order.  bf16: one bf16 rounding of the output
# (2^-8 relative) and of the 1x1 reduce, which may land on either side.
TOLERANCE = {torch.float32: (1e-4, 1e-4), torch.bfloat16: (2e-2, 2e-2)}
# main-path shape of every level-3 block: crop batch 32, 512x1024 / 8
K1_SHAPE = (32, 64, 128, 128)
# K1's tiling edges: H and W not multiples of its (2, 128) tile; H < 16, so
# every d8 and d16 tap but the centre is padding; the C=64 (level-2) width
K1_EDGE_SHAPES = ((3, 9, 70, 128), (2, 8, 16, 128), (2, 33, 45, 64))
# device time of K1 in the traced packed slide and that slide's idle share
# with the CUDA-core design K1 had before its products moved to the tensor
# cores (one H100 80GB HBM3 at 700 W, PERF.md)
K1_CUDA_CORE_SLIDE_MS, K1_CUDA_CORE_IDLE = 174.0, "0.22-0.27"
# the packed engine's level 2: crop batch 32, 512x1024 / 4, 5 folds x 64
# channels (n = 60, n1 = 80), and its padded layout (W + 2*HALO, C to 384)
K2_SHAPE = (32, 128, 256, 320)
K2_PADDED = (32, 128, 256 + 2 * HALO, 384)
K2_FOLDS = 5
# K2's edges: (B, H, W, folds).  H < 16, so every d8 and d16 tap but the
# centre is padding; W not a multiple of the 64-column strip; two folds
K2_EDGE_SHAPES = ((3, 9, 70, 5), (2, 33, 100, 2))
# device time of K2 in the traced packed K2 slide with the CUDA-core design
# it had before its products moved to the tensor cores (one H100 80GB HBM3
# at 700 W, PERF.md)
K2_CUDA_CORE_SLIDE_MS = 163.5
# the detector's NMS problems per window batch of 8: (P, N, k, IoU)
K3_SHAPES = {"rpn": (8, 2000, 300, 0.7), "second": (8, 300, 100, 0.6)}
# the frozen-graph backend's pre_nms_top_n, and the kernel's largest N
K3_LARGE = ((2, 6000, 300, 0.7), (2, 8192, 300, 0.7))
# float32 operations per box in a greedy step that emits a box: the IoU
# (2 min, 2 max, 2 sub, 2 clamp, mul, add, sub, div), the threshold and
# winner compares, the suppression select, and the argmax compare
K3_OPS_PER_BOX = 14
# the e2e operating point: 2000 um windows, overlap 0.1, 40x at
# 0.2265 um/px, level 3 (downsample 8) -> ceil(2000 / 0.2265 / 8) = 1104 px
DET_WINDOW_UM, DET_OVERLAP, DET_MPP, DET_BATCH = 2000, 0.1, 0.2265, 8
DET_WINDOW_PX = 1104
# level-3 size of the smoke slide (level 0 is 35328 x 26496): 5 x 4 windows
DET_LEVEL3_HW = (3312, 4416)
# the frozen-graph detector at that point: keep_aspect_ratio_resizer 600 /
# 1024 takes the 1104-px window to 600x600 (38 x 38 x 12 = 17,328 anchors),
# and its NMS problems per window batch of 8 are (P, N, k, IoU)
OD_RESIZED = (600, 600)
OD_K3_SHAPES = {"rpn": (8, 6000, 300, 0.7), "second": (8, 300, 100, 0.6)}
# the end-to-end phase: two jobs (patient ids) over one written slide, so
# that run_slides overlaps slides; level 0 is the detector stub's level 3
# in 8x8 blocks (35328 x 26496 at 0.2265 um/px, 40x), so the scan reads the
# same 20 windows at level 3.  Two, not three: the staged-detect, warm-up
# and server phases after it take the third slide's time
E2E_JOBS = ("E2E-1", "E2E-2")
# JPEG q90 tiles, the synthetic writer's default: the card's machine has
# PIL (12.2.0 when this was set), which the reader decodes them with
E2E_COMPRESSION = "jpeg"
# random_od_api_consts seed of the e2e detector: its scores decide how many
# boxes pass the CLI's thresholds (conf 0.2, merge 0.9) and how large they
# are.  Seed 0 merges 134 boxes a slide, none degenerate (e2e_seeds.py);
# seed 4's boxes are smaller, but some have zero height, which the
# segmenter of both packages cannot crop

E2E_DETECTOR_SEED = 0
# the staged segment phase: a GT slide of 12288 x 9216 px at the e2e
# phase's 0.2265 um/px, 40x, with 32 glomeruli of radius 40 to 65 px at
# level 3 (320 to 520 px at level 0) on a jittered 4 x 8 grid, so that no
# two GT boxes (and their 20 um margin frames' right and bottom edges) meet
# or leave the slide; two false positives lie between the first two rows.
# The patient id has 9 characters: scan_files keys a slide by the first 9
# characters of its name
SEG_SLIDE_HW, SEG_GRID, SEG_PATIENT = (9216, 12288), (4, 8), "S24-00001"
SEG_RADII = (40, 65)
SEG_FALSE_POSITIVES = ((800, 1900, 1500, 2600), (6000, 1950, 6600, 2550))
SEG_BATCH = 8
# the SegFormer/GTCS family at the published MiT widths: mit-b0 (the JAX
# package's SegformerConfig() default and the trainer's default backbone)
# and mit-b4 (the geometry of the reference test's default model,
# segformer/20220804_b4), 5 labels, 512x512 input; port-initialised seeded
# weights with the classifier scaled, which widens the logits' top-2 margins
SEGFORMER_CONFIGS = {
    "mit-b0": SegformerConfig(),
    "mit-b4": SegformerConfig(hidden_sizes=(64, 128, 320, 512),
                              depths=(3, 8, 27, 3), decoder_hidden_size=768),
}
SEGFORMER_BATCH = {"mit-b0": 32, "mit-b4": 8}
SEGFORMER_SEED, SEGFORMER_CLASSIFIER_SCALE = 0, 8.0
SEGFORMER_INPUT = 512
# the card-vs-CPU check of the b0 forward: batch, logit tolerance, and the
# least share of pixels whose argmax must agree
SEGFORMER_PARITY = (8, 1e-3, 0.999)
# the staged GTCS chain's data tree: site and date of its layout
GTCS_SITE, GTCS_DATE = "01_Todai", "20260101"
# the reader phase's concurrent read: threads, each with its own slide
# object (the Python reader shares a file position), as in gseg-e2e, where
# the detector, the crop producer and the overlay read at once
READER_THREADS = 4
# the training phase: a synthetic ESPNet dataset of PAS-like BGR crops
# with palette labels in 0..4 (train, val, height, width): 48 training
# crops give every scale steps past the first of its shape (batches of 8,
# 12 and 10); the reference recipe's model and batch; the card-vs-CPU
# step's batch at the main scale; the bf16 step's batch (the main scale's
# batch_size + 2); SegFormer: a GTCS tree of 5 specimens x 2 crops of
# 512 px (fold 1: 8 training crops), the trainer at batch 2 with
# accumulation 2 for 2 epochs
TRAIN_DATA = (48, 12, 512, 1024)
TRAIN_CLASSES, TRAIN_P, TRAIN_Q, TRAIN_BATCH = 5, 2, 8, 8
TRAIN_PARITY_BATCH, TRAIN_BF16_BATCH, TRAIN_TIMED_STEPS = 2, 10, 5
TRAIN_MAIN_WH = (1024, 512)
# card vs CPU, one f32 step each from equal state, TF32 off: loss
# (relative), gradients (largest difference over the largest gradient), BN
# running statistics and well-conditioned parameters (absolute); Adam's
# ill-conditioned elements (sqrt of the corrected v below 100 eps) are held
# to its bound of 2 lr; bf16 against f32 loss (relative)
TRAIN_PARITY = {"loss": 1e-5, "grad": 1e-4, "stats": 1e-5, "param": 1e-5}
TRAIN_BF16_RTOL = 5e-2
SEGFORMER_TRAIN = (5, 2, 512)
# the detector training phase on the staged GT slide's windows: the
# trainers' defaults (512x512 windows at ds8, batch 4, lr 1e-3); steps of
# the native ResNet-50-C4 in f32 and in bf16, and of the OD-API fine-tune
# (64 proposals); the first steps of a run left out of its steady state;
# the card-vs-CPU step's batch; the K3 problems of a training step, (P, N,
# k, IoU): the native RPN (4, 2000 -> 300) and the fine-tune's (4, 6000 ->
# 64)
DET_TRAIN_SIZE, DET_TRAIN_BATCH, DET_TRAIN_LR = 512, 4, 1e-3
DET_TRAIN_BACKBONE = "resnet50"
DET_TRAIN_STEPS = {"native f32": 30, "native bf16": 20, "od_api f32": 20}
DET_TRAIN_WARM, DET_TRAIN_PARITY_BATCH = 3, 1
K3_TRAIN_SHAPES = {"native": (4, 2000, 300, 0.7),
                   "od_api": (4, 6000, 64, 0.7)}
# Adam's first update turns on float32 rounding where |g| is under 1000 eps
# (it moves the update by lr * eps * dg / |g|^2): such elements are held to
# its bound of two lr (tests/test_torch_detector_driver.py)
DET_ILL_CONDITIONED = 1000 * 1e-8
# the card against the CPU: the CPU's own float32 noise floor (half its
# threads, so another summation order in some reductions) times this,
# where that is above TRAIN_PARITY: the card's order differs in every
# reduction.  After 30 steps, gradients of this BN-heavy network agree only
# to ~1e-3 of the largest between any two summation orders
DET_NOISE_FACTOR = 10


def check(ok: bool, message: str) -> None:
    if not ok:
        raise RuntimeError(message)


def card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()
    return out[0]


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of ``fn()`` over ``iters`` launches, after
    ``warmup`` launches."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


# ---------------- kernels K1 and K2: the ESP block ----------------
def block_case(label: str, kernel, plain, x, operands, pixels: int,
               after=None, timed: bool = True, plain_operands=None,
               groups: int = 1, split: str = None) -> dict:
    """An ESP block kernel against its plain version on ``x`` (f32 or bf16)
    and the f32 ``operands`` (w1, wd, scale, bias, alpha; the plain version
    takes ``plain_operands`` where they differ, as K2's dense ones from its
    per-group ones), both timed in turns unless not ``timed``; the bound
    from what the call must move and compute.  ``after`` checks the
    kernel's output further."""
    dtype = x.dtype

    def on_card(ops):
        w1, wd = (t.to("cuda", dtype) for t in ops[:2])
        return (x, w1, wd, *(t.cuda() for t in ops[2:]))

    args = on_card(operands)
    plain_args = args if plain_operands is None else on_card(plain_operands)
    y = kernel(*args)
    torch.cuda.synchronize()
    ref = plain(*plain_args)
    torch.cuda.synchronize()
    err = (y.float() - ref.float()).abs()
    atol, rtol = TOLERANCE[dtype]
    bad = int((err > atol + rtol * ref.float().abs()).sum())
    check(bool(torch.isfinite(y).all()), f"{label} {dtype}: non-finite")
    check(bad == 0, f"{label} {dtype}: {bad} values outside atol {atol} "
                    f"rtol {rtol} (max abs err {err.max().item():.3e})")
    if after is not None:
        after(y)
    max_abs = err.max().item()
    max_rel = (err / ref.float().abs().clamp_min(1e-3)).max().item()
    out_numel = y.numel()
    del y, ref, err
    if not timed:
        return {"dtype": str(dtype).replace("torch.", ""),
                "shape": list(x.shape), "max_abs_err": max_abs,
                "max_rel_err": max_rel, "tolerance": [atol, rtol]}
    # plain, kernel, kernel, plain: one card, in turns
    times = {"plain": [], "kernel": []}
    for name in ("plain", "kernel", "kernel", "plain"):
        if name == "plain":
            times[name].append(cuda_ms(lambda: plain(*plain_args)))
        else:
            times[name].append(cuda_ms(lambda: kernel(*args)))
    c, n = plain_args[1].shape
    size = x.element_size()
    # the input's logical pixels read once (K2's halo columns and pad
    # channels are zero by contract), the whole output written once, the
    # weights the kernel takes
    nbytes = ((pixels * c + out_numel + args[1].numel() + args[2].numel())
              * size + 3 * c * 4)
    # 1x1 reduce C->n, then 9n-deep products into n1 + 4n = C outputs; of
    # G independent blocks side by side only the diagonal blocks count
    dense_ops = 2 * pixels * (c * n + 9 * n * c)
    ops = dense_ops // groups
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS_PER_S[dtype] * 1e3
    # the kernel's passes, from a trace of 5 calls
    parts = {} if split is None else kernel_split(
        trace(lambda: [kernel(*args) for _ in range(5)]), split, 5)
    return {"dtype": str(dtype).replace("torch.", ""),
            "shape": list(x.shape),
            "max_abs_err": max_abs, "max_rel_err": max_rel,
            "tolerance": [atol, rtol], "split_ms": parts,
            "ms": float(np.mean(times["kernel"])),
            "plain_ms": float(np.mean(times["plain"])),
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "gbytes": nbytes / 1e9, "gflop": ops / 1e9,
            "gflop_dense": dense_ops / 1e9,
            "dense_bound_ms": max(t_bytes, dense_ops / PEAK_OPS_PER_S[dtype]
                                  * 1e3)}


def print_block_case(label: str, r: dict, name_power: str) -> None:
    dense = "" if r["gflop_dense"] == r["gflop"] else (
        f"; counting the zero cross-fold blocks too {r['gflop_dense']:.2f} "
        f"GFLOP, bound {r['dense_bound_ms'] * 1e3:.1f} us")
    print(f"{label} {r['dtype']} {tuple(r['shape'])}: max abs err "
          f"{r['max_abs_err']:.3e} max rel err {r['max_rel_err']:.3e} "
          f"(tolerance atol {r['tolerance'][0]} rtol {r['tolerance'][1]}); "
          f"kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, bound "
          f"{r['bound_ms'] * 1e3:.1f} us by {r['bound_by']} "
          f"({r['gbytes']:.3f} GB, {r['gflop']:.2f} GFLOP{dense}); "
          f"{r['gflop'] / r['ms']:.1f} TFLOP/s, "
          f"{r['bound_ms'] / r['ms']:.1%} of the bound; "
          + "".join(f"{k} {v:.4f} ms, " for k, v in r["split_ms"].items())
          + f"library: no single PyTorch call computes the block | "
          f"{name_power}", flush=True)


def kernel_name(symbol: str) -> str:
    """``name<template args>`` of a mangled kernel symbol of the port."""
    found = re.search(r"\d+([a-z][a-z_]*?_kernel)I?(\w*)", symbol)
    if not found:
        return symbol
    args = re.findall(r"Li(\d+)E|^(f)|^13__nv_(bfloat16)", found.group(2))
    return found.group(1) + "<" + ",".join("".join(a) for a in args) + ">"


def ptxas_summary(log: str) -> list:
    """``kernel<template args>: registers, barriers, static shared memory,
    spills`` per kernel, from the ``-Xptxas -v`` output of one build."""
    out, kernel, spills = [], "?", ""
    for line in log.splitlines():
        entry = re.search(r"Compiling entry function '(\w+)'", line)
        if entry:
            kernel = kernel_name(entry.group(1))
        elif "spill" in line:
            spills = line.strip()
        elif "registers" in line:
            out.append(f"{kernel}: {line.split('Used ')[-1].strip()}, "
                       f"{spills}")
    return out


def sass_mma_counts(name: str):
    """{kernel: tensor-core instructions (HMMA, or HGMMA for wgmma)} of a
    built library, from ``cuobjdump -sass``; None where the toolkit has no
    cuobjdump."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not Path(tool).is_file():
        return None
    sass = subprocess.run([tool, "-sass", str(_build.library_path(name))],
                          capture_output=True, text=True, timeout=120,
                          check=True).stdout
    counts, current = {}, None
    for line in sass.splitlines():
        found = re.search(r"Function : (\S+)", line)
        if found:
            current = kernel_name(found.group(1))
            counts[current] = 0
        elif current and re.search(r"\bHG?MMA\.", line):
            counts[current] += 1
    return counts


def check_sass(label: str, source: str, mma_kernels: int,
               name_power: str) -> None:
    """The bf16 kernels of ``source`` (named ``*_mma_kernel``) must use the
    tensor cores, its f32 kernels not."""
    counts = sass_mma_counts(source)
    if counts is None:
        print(f"{label} sass: cuobjdump not found, tensor-core instructions "
              f"not counted")
        return
    for kernel, hmma in sorted(counts.items()):
        print(f"{label} sass: {hmma} tensor-core (HMMA/HGMMA) instructions "
              f"in {kernel} | {name_power}")
        check(("_mma_kernel" in kernel) == (hmma > 0),
              f"{label} kernel {kernel} has {hmma} tensor-core instructions")
    check(sum("_mma_kernel" in s_ for s_ in counts) == mma_kernels,
          f"{label} tensor-core kernels built: {sorted(counts)}")


def check_zero_padding(y, c: int) -> None:
    """K2's output keeps the padded layout: zero halo columns and zero pad
    channels, exactly."""
    check(bool((y[:, :, :HALO] == 0).all() and (y[:, :, -HALO:] == 0).all()),
          "K2: nonzero halo columns in the output")
    check(bool((y[..., c:] == 0).all()), "K2: nonzero pad channels")


def first_folds(ops, folds: int):
    """K2's per-fold operands of the packed level 2 cut to its first
    ``folds`` folds, as a ``folds``-fold pack: (per-fold operands, dense
    operands for the plain version)."""
    w1, wd, *vecs = ops
    src = esp_group_channels(K2_SHAPE[3], w1.shape[0] * w1.shape[2],
                             w1.shape[0])[:folds].reshape(-1)
    dst = esp_group_channels(64 * folds, w1.shape[2] * folds,
                             folds).reshape(-1)
    cut = []
    for v in vecs:
        out = torch.empty(64 * folds, dtype=v.dtype)
        out[torch.from_numpy(dst)] = v[torch.from_numpy(src)]
        cut.append(out)
    w1, wd = w1[:folds].contiguous(), wd[:folds].contiguous()
    return [w1, wd, *cut], [*unpack_esp_groups(w1, wd), *cut]


# ---------------- the slice: a synthetic slide ----------------
class NumpySlide:
    """An in-memory slide: ``.dimensions`` and ``read_region_array`` over an
    RGB uint8 array; pixels outside the image read white."""

    def __init__(self, image: np.ndarray):
        self.image = image
        self.dimensions = (image.shape[1], image.shape[0])

    def read_region_array(self, location, level, size):
        check(level == 0, "NumpySlide has level 0 only")
        (x0, y0), (w, h) = location, size
        out = np.full((h, w, 3), 255, np.uint8)
        ys, xs = max(y0, 0), max(x0, 0)
        ye = min(y0 + h, self.image.shape[0])
        xe = min(x0 + w, self.image.shape[1])
        if ye > ys and xe > xs:
            out[ys - y0: ye - y0, xs - x0: xe - x0] = \
                self.image[ys:ye, xs:xe]
        return out


def synthetic_slide(seed: int, height: int, width: int, n_boxes: int,
                    box_min: int, box_max: int):
    """A PAS-like slide (pink noisy background, dark round blobs) and one
    detection box per blob, sized ``box_min`` to ``box_max`` pixels; the
    last box overhangs the right edge."""
    rng = np.random.RandomState(seed)
    img = np.empty((height, width, 3), np.uint8)
    for row in range(0, height, 1024):
        band = img[row: row + 1024]
        noise = rng.randint(-12, 12, band.shape, dtype=np.int16)
        band[:] = np.clip(noise + np.asarray((230, 205, 215), np.int16),
                          0, 255)
    boxes = []
    for i in range(n_boxes):
        bw, bh = rng.randint(box_min, box_max + 1, 2)
        x1 = width - bw // 2 if i == n_boxes - 1 else \
            rng.randint(0, width - bw)
        y1 = rng.randint(0, height - bh)
        boxes.append([int(x1), int(y1), int(x1 + bw), int(y1 + bh), 0.9])
        cy, cx = y1 + bh // 2, x1 + bw // 2
        r = min(bw, bh) * 3 // 8
        y_lo, y_hi = max(cy - r, 0), min(cy + r, height)
        x_lo, x_hi = max(cx - r, 0), min(cx + r, width)
        yy, xx = np.mgrid[y_lo:y_hi, x_lo:x_hi]
        d2 = (yy - cy) ** 2 + (xx - cx) ** 2
        patch = img[y_lo:y_hi, x_lo:x_hi]
        patch[d2 < r * r] = (170, 110, 150)
        patch[d2 < (r // 2) ** 2] = (140, 80, 120)
    return NumpySlide(img), boxes


def write_checkpoints(folder: Path, classes: int, p: int, q: int):
    folder.mkdir(parents=True, exist_ok=True)
    paths = []
    for fold in range(1, 6):
        path = folder / f"espnet_fold{fold}.pth"
        torch.save(random_state_dict(fold, classes, p, q), path)
        paths.append(str(path))
    return paths


def segment(ensemble, slide, boxes):
    """One timed segment_slide; returns (canvas, seconds, (K1 launches, K2
    launches))."""
    seg = FusedSlideSegmenter(ensemble)
    torch.cuda.synchronize()
    esp_block_fused.launches = esp_block_padded.launches = 0
    t0 = time.perf_counter()
    canvas = seg.segment_slide(slide, boxes)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    return canvas, seconds, (esp_block_fused.launches,
                             esp_block_padded.launches)


def check_canvas(canvas, slide, boxes, classes: int, label: str) -> None:
    width, height = slide.dimensions
    check(canvas.shape == (height // 8, width // 8),
          f"{label}: canvas shape {canvas.shape}")
    check(int(canvas.max()) < classes, f"{label}: canvas max {canvas.max()}")
    check(outside_boxes_is_background(canvas, boxes),
          f"{label}: canvas has labels outside every box")


def _kernel_group(name: str) -> str:
    if "esp_dma_" in name:
        return "K2 esp_block_dma"
    if "esp_reduce" in name or "esp_branch" in name:
        return "K1 esp_block"
    if re.search(r"nms_(sort|mask|scan)_kernel", name):
        return "K3 nms"
    low = name.lower()
    if low.startswith("memcpy") or low.startswith("memset"):
        return "copies"
    # cuDNN's convolutions; cuBLAS (nvjet, cutlass) runs some 1x1 convs and
    # the box head's Linear layers
    if any(k in low for k in ("conv", "xmma", "implicit", "cudnn", "gemm",
                              "dgrad", "wgrad", "winograd", "fft", "nvjet",
                              "cutlass")):
        return "cuDNN/cuBLAS conv"
    if "index" in low or "gather" in low:
        return "gathers"
    return "other (elementwise, sort, softmax, argmax)"


def trace(fn) -> dict:
    """One traced run of ``fn()``, apart from the timed runs: device time
    by kernel group and the device's idle share of the traced wall time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels, ops = {}, {}
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = e.self_cuda_time_total
        if e.device_type == DeviceType.CUDA:
            kernels[e.key] = (us / 1e3, e.count)
        elif e.key.startswith("aten::") and us > 0:
            # device time of the kernels this operator launched itself
            ops[e.key] = (us / 1e3, e.count)
    busy_ms = sum(ms for ms, _ in kernels.values())
    groups = {}
    for name, (ms, _) in kernels.items():
        group = _kernel_group(name)
        groups[group] = groups.get(group, 0.0) + ms
    top = sorted(kernels.items(), key=lambda kv: -kv[1][0])[:12]
    top_ops = sorted(ops.items(), key=lambda kv: -kv[1][0])[:10]
    return {"wall_ms": wall_ms, "device_busy_ms": busy_ms,
            "idle_share": 1 - busy_ms / wall_ms if wall_ms else None,
            "groups_ms": groups, "ops_ms": ops,
            "top": [[name[:90], ms, count] for name, (ms, count) in top],
            "top_ops": [[name, ms, count] for name, (ms, count) in top_ops]}


def kernel_split(prof: dict, pattern: str, calls: int) -> dict:
    """Device ms per call of each kernel of a trace whose name matches
    ``pattern`` (its first group names it)."""
    split = {}
    for name, ms, _ in prof["top"]:
        found = re.search(pattern, name)
        if found:
            split[found.group(1)] = split.get(found.group(1), 0.0) + \
                ms / calls
    return split


def print_trace(title: str, prof: dict, name_power: str) -> None:
    print(f"profile {title} (traced run): wall {prof['wall_ms']:.1f} ms, "
          f"device busy {prof['device_busy_ms']:.1f} ms, idle share "
          f"{prof['idle_share']:.3f}; by group (ms): "
          + ", ".join(f"{k} {v:.1f}" for k, v in
                      sorted(prof["groups_ms"].items(), key=lambda kv: -kv[1]))
          + f" | {name_power}")
    for kname, ms, count in prof["top"]:
        print(f"  {ms:9.2f} ms {count:6d}x  {kname}")
    print("  by the operator that launched the kernels: " + ", ".join(
        f"{name} {ms:.2f} ms/{count}" for name, ms, count in prof["top_ops"]))


def conv_flops(model, images, anchors) -> float:
    """Operations of every convolution and linear layer in one detect call,
    counted from the shapes they see (2 per multiply-add)."""
    total = [0]

    def hook(module, inputs, out):
        if isinstance(module, torch.nn.Conv2d):
            k = module.in_channels // module.groups * \
                module.kernel_size[0] * module.kernel_size[1]
        else:
            k = module.in_features
        total[0] += 2 * out.numel() * k

    handles = [m.register_forward_hook(hook) for m in model.modules()
               if isinstance(m, (torch.nn.Conv2d, torch.nn.Linear))]
    try:
        model.detect(images, anchors)
    finally:
        for h in handles:
            h.remove()
    return float(total[0])


def outside_boxes_is_background(canvas, boxes) -> bool:
    mask = np.zeros(canvas.shape, bool)
    for x1, y1, x2, y2, _ in boxes:
        mask[y1 // 8: y2 // 8, x1 // 8: x2 // 8] = True
    return bool((canvas[~mask] == 0).all())


# ---------------- the packed engine ----------------
def packed_phase(config, fused, slide, boxes, fused_canvas,
                 name_power: str) -> tuple:
    """The fold-packed engine on the bf16 slide with the plain level 2, with
    K2, and with the plain level 3 in place of K1, timed in turns with the
    fused engine; launch counts and canvases checked; every packed form
    traced; the engine's own plain level-2 block timed at K2's shape.
    Returns (K2's launches in its timed run, that block's ms)."""
    bs = config.batch_size
    n_batches = math.ceil(len(boxes) / bs)
    want_k1 = config.q * len(config.folds) * n_batches
    want_k2 = config.p * n_batches
    default = EnsembleSegmenter(config, engine="packed")
    engines = {"fused": fused,
               "packed plain L2": EnsembleSegmenter(config, engine="packed",
                                                    fuse_level2=False),
               "packed K2": EnsembleSegmenter(config, engine="packed",
                                              fuse_level2=True),
               "packed plain L3": EnsembleSegmenter(config, engine="packed",
                                                    fuse_level3=False)}
    check(default.fuse_level3 and not default.fuse_level2
          and engines["packed K2"].fuse_level2
          and not engines["packed plain L2"].fuse_level2
          and not engines["packed plain L3"].fuse_level3
          and engines["packed plain L3"].fuse_level2 == default.fuse_level2,
          "packed engine options")
    print(f"packed engine default: fuse_level2={default.fuse_level2}, "
          f"fuse_level3={default.fuse_level3}", flush=True)
    del default
    for name in ("packed plain L2", "packed K2", "packed plain L3"):
        segment(engines[name], slide, boxes[:bs])  # warm-up
    secs, peak, counts, canvases = {}, {}, {}, {}
    # plain level 2 against K2, nested in K1 against the plain level 3 and
    # in the fused engine: each pair in turns, plain, kernel, kernel, plain
    for name in ("fused", "packed plain L3", "packed plain L2", "packed K2",
                 "packed K2", "packed plain L2", "packed plain L3", "fused"):
        torch.cuda.reset_peak_memory_stats()
        out, t, n = segment(engines[name], slide, boxes)
        peak[name] = max(peak.get(name, 0.0),
                         torch.cuda.max_memory_allocated() / 1e9)
        check_canvas(out, slide, boxes, config.classes, name)
        want = (0 if name == "packed plain L3" else want_k1,
                want_k2 if engines[name].fuse_level2 else 0)
        if name != "fused":
            check(n == want, f"{name}: (K1, K2) launched {n}, want {want}")
        secs.setdefault(name, []).append(t)
        counts[name] = n
        canvases.setdefault(name, out)
    for name, ts in secs.items():
        med = float(np.median(ts))
        print(f"slice bf16 batch {bs}, engine {name}: s/slide in turns "
              + ", ".join(f"{t:.4f}" for t in ts)
              + f" (median {med:.4f}, {len(boxes) / med:.2f} crops/s); "
              f"(K1, K2) launches {counts[name]}; peak memory "
              f"{peak[name]:.3f} GB; canvas pixels equal to the fused "
              f"engine's first run {(canvases[name] == fused_canvas).mean():.6f}"
              f" | {name_power}", flush=True)
    gain = [p_ - k_ for p_, k_ in zip(secs["packed plain L2"],
                                      secs["packed K2"][::-1])]
    spread = {name: max(secs[name]) - min(secs[name])
              for name in ("packed plain L2", "packed K2")}
    ahead = min(gain) > max(spread.values())
    print(f"fuse_level2 in turns: plain level 2 minus K2, per pair of turns "
          + ", ".join(f"{g:+.4f}" for g in gain) + " s/slide; spread "
          f"between turns: plain level 2 {spread['packed plain L2']:.4f}, K2 "
          f"{spread['packed K2']:.4f} s; K2 ahead in both pairs by more than "
          f"either spread: {ahead} | {name_power}", flush=True)
    traces = {}
    for name in ("packed plain L2", "packed K2", "packed plain L3"):
        ens = engines[name]
        traces[name] = trace(
            lambda: FusedSlideSegmenter(ens).segment_slide(slide, boxes))
        print_trace(f"bf16 slide, engine {name}", traces[name], name_power)
    # "packed plain L3" keeps the default level 2 (plain): against it, the
    # default ("packed plain L2") isolates K1, and against that the K2
    # engine isolates K2
    plain_l2, with_k2 = traces["packed plain L2"], traces["packed K2"]
    k1_ms = plain_l2["groups_ms"].get("K1 esp_block", 0.0)
    print(f"K1 in the traced packed slide (the default, plain level 2): "
          f"{k1_ms:.1f} ms of {plain_l2['device_busy_ms']:.1f} ms device "
          f"busy, idle share {plain_l2['idle_share']:.3f}; the CUDA-core K1 "
          f"took {K1_CUDA_CORE_SLIDE_MS} ms, idle {K1_CUDA_CORE_IDLE}; with "
          f"the plain level 3: "
          f"{traces['packed plain L3']['device_busy_ms']:.1f}"
          f" ms busy, idle {traces['packed plain L3']['idle_share']:.3f} | "
          f"{name_power}", flush=True)
    k2_ms = with_k2["groups_ms"].get("K2 esp_block_dma", 0.0)
    print(f"K2 in the traced packed K2 slide: {k2_ms:.1f} ms of "
          f"{with_k2['device_busy_ms']:.1f} ms device busy, idle share "
          f"{with_k2['idle_share']:.3f}; the CUDA-core K2 took "
          f"{K2_CUDA_CORE_SLIDE_MS} ms; with the plain level 2: "
          f"{plain_l2['device_busy_ms']:.1f} ms busy | {name_power}",
          flush=True)
    # K2's composed-ops reference: the engine's own plain level-2 block
    # (bf16 channels-last cuDNN convolutions and elementwise ops) at K2's
    # shape, one call
    pack = engines["packed plain L2"]._packed.enc["level2"][0]
    b_, h_, w_, c_ = K2_SHAPE
    x = torch.randn((b_, c_, h_, w_), device="cuda").to(torch.bfloat16) \
        .contiguous(memory_format=torch.channels_last)
    with torch.no_grad():
        composed_ms = cuda_ms(lambda: _esp_plain(pack, x))
    print(f"K2 composed-ops reference: the packed engine's plain level-2 "
          f"block, bf16 channels-last, {tuple(x.shape)}: {composed_ms:.4f} "
          f"ms per call | {name_power}", flush=True)
    del x
    return counts["packed K2"][1], composed_ms


def packed_f32_phase(config, slide, boxes, fused_canvas,
                     name_power: str) -> None:
    """f32 "highest": the packed canvases with K2 and with the plain level 2
    must agree; the packed-against-fused agreement is printed."""
    n_batches = math.ceil(len(boxes) / config.batch_size)
    runs = {}
    for fuse_level2 in (False, True):
        ens = EnsembleSegmenter(config, engine="packed",
                                fuse_level2=fuse_level2)
        out, t, n = segment(ens, slide, boxes)
        del ens
        want = (config.q * len(config.folds) * n_batches,
                config.p * n_batches if fuse_level2 else 0)
        check(n == want, f"packed f32: (K1, K2) launched {n}, want {want}")
        check_canvas(out, slide, boxes, config.classes, "packed f32")
        runs[fuse_level2] = (out, t)
    same = float((runs[True][0] == runs[False][0]).mean())
    vs_fused = float((runs[False][0] == fused_canvas).mean())
    print(f"packed f32 highest: K2 {runs[True][1]:.4f} s/slide, plain level "
          f"2 {runs[False][1]:.4f} s/slide; equal canvas pixels K2 vs plain "
          f"level 2 {same:.6f}, packed vs fused engine {vs_fused:.6f} of "
          f"{fused_canvas.size} | {name_power}", flush=True)
    check(same >= 0.999, f"f32 packed K2/plain canvases agree on {same}")


# ---------------- kernel K3: greedy NMS ----------------
def seeded_nms_problem(seed: int, p: int, n: int):
    """P sets of N overlapping boxes in a 1104-px window; scores on a grid
    of 1/256, so equal scores are common and the tie order is exercised."""
    rng = np.random.RandomState(seed)
    centers = rng.uniform(0, DET_WINDOW_PX, (p, n, 2))
    sizes = rng.uniform(16, 400, (p, n, 2))
    boxes = np.concatenate([centers - sizes / 2, centers + sizes / 2], -1)
    scores = np.round(rng.uniform(0, 1, (p, n)) * 256) / 256
    return (torch.from_numpy(boxes.astype(np.float32)).cuda(),
            torch.from_numpy(scores.astype(np.float32)).cuda())


def nms_case(boxes, scores, k: int, thr: float,
             score_threshold: float = float("-inf")) -> dict:
    """K3 against nms_plain on one batch of problems: equal indices and
    counts; both timed in turns; the bound from what this input needs."""
    p, n = scores.shape
    idx, num = nms(boxes, scores, k, thr, score_threshold)
    torch.cuda.synchronize()
    masked = premask(scores, score_threshold)
    want_idx, want_num = nms_plain(boxes, masked, k, thr)
    torch.cuda.synchronize()
    check(torch.equal(idx, want_idx) and torch.equal(num, want_num),
          f"K3 ({p}, {n}) -> {k}: indices differ from nms_plain at "
          f"{int((idx != want_idx).sum())} of {idx.numel()} slots")
    times = {"plain": [], "kernel": []}
    for name in ("plain", "kernel", "kernel", "plain"):
        if name == "kernel":
            times[name].append(cuda_ms(
                lambda: nms(boxes, scores, k, thr, score_threshold)))
        else:
            # 150 to 250 ms a call: few repeats keep the phase short
            times[name].append(cuda_ms(
                lambda: nms_plain(boxes, masked, k, thr), iters=2, warmup=1))
    # the kernel's own device time beside it: at these sizes a call's event
    # time is mostly the host's (premask, allocations, three launches)
    prof = trace(lambda: [nms(boxes, scores, k, thr, score_threshold)
                          for _ in range(10)])
    device_ms = prof["groups_ms"].get("K3 nms", 0.0) / 10
    split = kernel_split(prof, r"(nms_\w+?)_kernel", 10)
    valid = num.long().cpu()
    # a step that emits a box runs the whole IoU pass; the step that finds
    # no live box (when fewer than k are emitted) only the argmax
    ops = int((valid * n * K3_OPS_PER_BOX + (valid < k).long() * n).sum())
    nbytes = p * n * (16 + 4) + p * k * 4 + p * 4
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS_PER_S[torch.float32] * 1e3
    return {"shape": [p, n, k, thr], "emitted": valid.tolist(),
            "max_abs_err": float((idx - want_idx).abs().max()),
            "ms": float(np.mean(times["kernel"])), "device_ms": device_ms,
            "split_ms": split,
            "plain_ms": float(np.mean(times["plain"])),
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "kbytes": nbytes / 1e3, "mops": ops / 1e6}


def print_nms_case(label: str, r: dict, name_power: str) -> None:
    p, n, k, thr = r["shape"]
    print(f"K3 nms {label} ({p}, {n}) -> {k} IoU {thr}: indices and counts "
          f"equal to nms_plain, emitted {min(r['emitted'])}.."
          f"{max(r['emitted'])}; kernel {r['ms']:.4f} ms a call by events, "
          f"host included ({r['device_ms']:.4f} ms of device time: "
          + ", ".join(f"{k} {v:.4f}" for k, v in r["split_ms"].items())
          + f"), plain {r['plain_ms']:.4f} ms, bound "
          f"{r['bound_ms'] * 1e3:.2f} us by {r['bound_by']} "
          f"({r['kbytes']:.1f} kB, {r['mops']:.1f} M ops); library: no "
          f"single PyTorch call computes greedy NMS | {name_power}",
          flush=True)


# ---------------- the detector slice ----------------
class PyramidStub:
    """An in-memory slide whose pyramid holds level 3 only (downsample 8,
    RGB uint8); level 0 is 8x its size.  Pixels outside read white."""

    def __init__(self, level3: np.ndarray):
        self.level3 = level3
        self.level_count = 4
        self.level_downsamples = (1.0, 2.0, 4.0, 8.0)
        self.dimensions = (level3.shape[1] * 8, level3.shape[0] * 8)
        self.properties = {"openslide.mpp-x": str(DET_MPP),
                           "openslide.mpp-y": str(DET_MPP),
                           "openslide.objective-power": "40"}

    def read_region_array(self, location, level, size):
        check(level == 3, "PyramidStub has level 3 only")
        x0, y0 = int(location[0] / 8), int(location[1] / 8)
        (w, h), img = size, self.level3
        out = np.full((h, w, 3), 255, np.uint8)
        xs, ys = max(x0, 0), max(y0, 0)
        xe, ye = min(x0 + w, img.shape[1]), min(y0 + h, img.shape[0])
        if xe > xs and ye > ys:
            out[ys - y0: ye - y0, xs - x0: xe - x0] = img[ys:ye, xs:xe]
        return out


def pyramid_slide(seed: int) -> PyramidStub:
    """A seeded PAS-like level 3: pink noise, dark round glomerulus-sized
    blobs (radius 30 to 80 px at 1.8 um/px)."""
    rng = np.random.RandomState(seed)
    h, w = DET_LEVEL3_HW
    img = np.empty((h, w, 3), np.uint8)
    for row in range(0, h, 512):
        band = img[row: row + 512]
        noise = rng.randint(-12, 12, band.shape, dtype=np.int16)
        band[:] = np.clip(noise + np.asarray((230, 205, 215), np.int16),
                          0, 255)
    for _ in range(60):
        r = int(rng.randint(30, 81))
        cy, cx = int(rng.randint(r, h - r)), int(rng.randint(r, w - r))
        yy, xx = np.mgrid[-r:r, -r:r]
        patch = img[cy - r: cy + r, cx - r: cx + r]
        patch[yy ** 2 + xx ** 2 < r * r] = (170, 110, 150)
        patch[yy ** 2 + xx ** 2 < (r // 2) ** 2] = (140, 80, 120)
    return PyramidStub(img)


class RecordingBackend:
    """Forwards the async pair to a backend and keeps what it reads."""

    def __init__(self, backend):
        self.backend = backend
        self.batch_size = backend.batch_size
        self.results = []

    def detect_batch_submit(self, images):
        return self.backend.detect_batch_submit(images)

    def read_detections(self, handle):
        result = self.backend.read_detections(handle)
        self.results.append(result)
        return result


def check_detections(results, max_detections: int) -> int:
    """The frozen-graph output contract; returns the number of detections."""
    total = 0
    for boxes, scores, classes, num in results:
        check(bool(np.isfinite(boxes).all() and np.isfinite(scores).all()),
              "non-finite detections")
        check(bool((boxes >= 0).all() and (boxes <= 1).all()),
              "boxes outside [0, 1]")
        check(bool((boxes[..., 0] <= boxes[..., 2]).all()
                   and (boxes[..., 1] <= boxes[..., 3]).all()),
              "a box with ymin > ymax or xmin > xmax")
        check(bool((np.diff(scores, axis=1) <= 0).all()),
              "scores not sorted descending")
        check(bool((num <= max_detections).all() and (num >= 0).all()),
              f"num_detections {num}")
        check(bool((classes == 1).all()), "a class other than 1")
        total += int(num.sum())
    return total


def scan(detector, backend, slide, path: Path):
    """One timed scan_slide; returns (seconds, K3 launches, CSV rows)."""
    torch.cuda.synchronize()
    nms.launches = 0
    t0 = time.perf_counter()
    with open(path, "w") as out:
        detector.scan_slide(backend, slide, "smoke", "S1", "S1.ndpi", out)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    return seconds, nms.launches, len(path.read_text().splitlines())


def detector_phases(name_power: str):
    """K3 against its plain version, the detector slice at full width, the
    f32 kernel/plain comparison and a traced batch.  Returns (the K3
    cases, K3 launches of the timed scan)."""
    # ---- the detector: weights, one window batch, K3 against plain ----
    det_cfg = FasterRCNNConfig()
    t0 = time.perf_counter()
    det_state = random_detector_state(0, det_cfg)
    print(f"detector: ResNet-50-C4 Faster R-CNN, {det_cfg}; random weights "
          f"(seed 0), BN calibrated on the card in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    backend = TorchDetectorBackend(det_state, det_cfg, batch_size=DET_BATCH)
    slide3 = pyramid_slide(seed=1)
    step = int(DET_WINDOW_UM / DET_MPP * (1 - DET_OVERLAP))
    images = np.stack([
        slide3.read_region_array((step * i, step * j), 3,
                                 (DET_WINDOW_PX, DET_WINDOW_PX))
        for j in range(2) for i in range(5)][:DET_BATCH])
    backend.detect_batch(images)  # warm-up, not counted
    model = backend.model.with_image_size(DET_WINDOW_PX, DET_WINDOW_PX)
    anchors = build_anchors(model.config).cuda()
    with torch.no_grad():
        out = model(torch.from_numpy(images).cuda(), anchors)
        rpn_boxes, rpn_scores = model.rpn_candidates(
            out["rpn_objectness"], out["rpn_deltas"], anchors)
        cand_boxes, cand_scores = model.detection_candidates(
            out["proposals"], out["class_scores"], out["box_deltas"])
    del out
    check(tuple(rpn_scores.shape) == K3_SHAPES["rpn"][:2]
          and tuple(cand_scores.shape) == K3_SHAPES["second"][:2],
          f"NMS problems {tuple(rpn_scores.shape)}, "
          f"{tuple(cand_scores.shape)}")
    k3 = {}
    for label, (p_, n_, k_, thr) in K3_SHAPES.items():
        k3[f"{label} seeded"] = nms_case(*seeded_nms_problem(7, p_, n_),
                                         k_, thr)
    k3["rpn proposals"] = nms_case(rpn_boxes, rpn_scores,
                                   det_cfg.post_nms_top_n,
                                   det_cfg.rpn_nms_threshold)
    k3["second candidates"] = nms_case(cand_boxes, cand_scores,
                                       det_cfg.max_detections,
                                       det_cfg.second_nms_threshold,
                                       det_cfg.score_threshold)
    for p_, n_, k_, thr in K3_LARGE:
        k3[f"{n_} seeded"] = nms_case(*seeded_nms_problem(8, p_, n_), k_,
                                      thr)
    for label, r in k3.items():
        print_nms_case(label, r, name_power)

    # ---- the detector slice at full width, bf16 ----
    detector = GlomusDetector(
        "OPT_PAS", "", str(WORK), str(WORK / "detect"), "_smoke",
        window_size=DET_WINDOW_UM, overlap_ratio=DET_OVERLAP,
        # random weights carry no confidence: every detection is written
        conf_threshold=0.0, batch_size=DET_BATCH)
    recorder = RecordingBackend(backend)
    torch.cuda.reset_peak_memory_stats()
    det_s, det_launches, det_rows = scan(detector, recorder, slide3,
                                         WORK / "detect_kernel.csv")
    det_peak_gb = torch.cuda.max_memory_allocated() / 1e9
    geometry = detector.calc_window_size()
    check(geometry[2:] == (5, 4, DET_WINDOW_PX, DET_WINDOW_PX),
          f"window geometry {geometry}")
    n_windows = geometry[2] * geometry[3]
    det_batches = math.ceil(n_windows / DET_BATCH)
    check(len(recorder.results) == det_batches,
          f"{len(recorder.results)} batches read, want {det_batches}")
    check(det_launches == 2 * det_batches,
          f"K3 launched {det_launches} times, want {2 * det_batches}")
    n_det = check_detections(recorder.results, det_cfg.max_detections)
    top = max(float(r[1].max()) for r in recorder.results)
    print(f"detector slice bf16 batch {DET_BATCH}: {n_windows} windows of "
          f"{DET_WINDOW_PX}x{DET_WINDOW_PX} in {det_batches} batches, "
          f"{det_s:.4f} s/slide, {n_windows / det_s:.2f} windows/s, K3 "
          f"launches {det_launches}, peak memory {det_peak_gb:.3f} GB, "
          f"{n_det} detections (top score {top:.4f}), {det_rows} CSV rows | "
          f"{name_power}", flush=True)
    check(n_det > 0 and det_rows > 0, "no detections")
    plain_backend = TorchDetectorBackend(det_state, det_cfg,
                                         batch_size=DET_BATCH,
                                         kernel_nms=False)
    plain_backend.detect_batch(images)  # warm-up
    turns = {"kernel": [det_s], "plain": []}
    for name in ("plain", "kernel", "kernel", "plain"):
        secs, n_launch, _ = scan(
            detector, backend if name == "kernel" else plain_backend, slide3,
            WORK / f"detect_{name}.csv")
        check(n_launch == (det_launches if name == "kernel" else 0),
              f"{name} scan launched K3 {n_launch} times")
        turns[name].append(secs)
    same_rows = [ln.split(",")[5:] for ln in (
        WORK / "detect_kernel.csv").read_text().splitlines()] == \
        [ln.split(",")[5:] for ln in (
            WORK / "detect_plain.csv").read_text().splitlines()]
    print("detector slice bf16 s/slide in turns: K3 "
          + ", ".join(f"{s_:.4f}" for s_ in turns["kernel"])
          + f" (median {np.median(turns['kernel']):.4f}); plain NMS "
          + ", ".join(f"{s_:.4f}" for s_ in turns["plain"])
          + f" (median {np.median(turns['plain']):.4f}); CSV boxes and "
          f"scores equal: {same_rows} | {name_power}", flush=True)
    del plain_backend

    # ---- f32, TF32 off: detections with and without K3 are identical ----
    f32_same_with_and_without_k3(
        lambda kernel_nms: TorchDetectorBackend(
            det_state, det_cfg, batch_size=DET_BATCH,
            compute_dtype="float32", kernel_nms=kernel_nms),
        images, name_power, "detector")
    print_conv_trace("bf16 detector batch", backend, images, model,
                     torch.from_numpy(images).cuda(), anchors, name_power)
    return k3, det_launches


def print_conv_trace(title: str, backend, images, model, model_input,
                     anchors, name_power: str) -> None:
    """A traced ``detect_batch`` of one window batch: device time by group,
    idle share, and the convolutions' operations over their traced time."""
    prof = trace(lambda: backend.detect_batch(images))
    print_trace(f"{title} ({len(images)} windows)", prof, name_power)
    flops = conv_flops(model, model_input, anchors)
    conv_ms = prof["groups_ms"].get("cuDNN/cuBLAS conv", 0.0)
    rate = f"{flops / conv_ms / 1e9:.1f} TFLOP/s" if conv_ms else \
        "no convolution time traced"
    print(f"{title}: convolutions and linear layers {flops / 1e12:.3f} "
          f"TFLOP per batch of {len(images)}; at the traced {conv_ms:.2f} "
          f"ms {rate} | {name_power}", flush=True)


def f32_same_with_and_without_k3(make_backend, images, name_power: str,
                                 label: str) -> None:
    """One f32 batch (deterministic cuDNN; the backend's own TF32
    settings, cuDNN on and matmul off) through ``make_backend(kernel_nms)``
    with and without K3: the detections must be identical."""
    saved = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    runs = {}
    try:
        for kernel_nms in (True, False):
            b32 = make_backend(kernel_nms)
            nms.launches = 0
            t0 = time.perf_counter()
            runs[kernel_nms] = b32.detect_batch(images)
            runs[kernel_nms] += (time.perf_counter() - t0, nms.launches)
            del b32
    finally:
        torch.backends.cudnn.deterministic = saved
    same = all(np.array_equal(a, b) for a, b in
               zip(runs[True][:4], runs[False][:4]))
    print(f"{label} f32 (cuDNN TF32 on, matmul TF32 off), one batch of "
          f"{len(images)}: K3 "
          f"{runs[True][4]:.4f} s ({runs[True][5]} launches), plain NMS "
          f"{runs[False][4]:.4f} s ({runs[False][5]} launches); detections "
          f"identical: {same}; detections per window "
          f"{runs[True][3].astype(int).tolist()} | {name_power}", flush=True)
    check(runs[True][5] == 2 and runs[False][5] == 0,
          f"{label} f32 launch counts")
    check(same, f"{label} f32 detections differ with and without K3")


# ---------------- the frozen-graph (OD-API) detector ----------------
def od_api_phases(name_power: str):
    """The OD-API inception_v2 Faster R-CNN (the reference's frozen graph)
    at full width on seeded random constants: K3 against its plain version
    on one batch's real (8, 6000) and (8, 300) problems, the timed scan
    (6 K3 launches), the resize and NMS options in turns, the cv2 path, the
    f32 kernel/plain comparison and a traced batch.  Returns (the K3 cases,
    K3 launches of the timed scan)."""
    t0 = time.perf_counter()
    consts = random_od_api_consts(0)
    calib_s = time.perf_counter() - t0
    backend = ODAPIDetectorBackend(consts=consts, batch_size=DET_BATCH)
    cfg = backend.base_config
    n_params = sum(p.numel() for p in backend.model.parameters())
    print(f"OD-API detector: inception_v2 Faster R-CNN, {cfg}; "
          f"{n_params / 1e6:.3f} M parameters (slim inception_v2 at depth "
          f"multiplier 1.0, RPN depth "
          f"{backend.params['rpn_conv']['w'].shape[3]}), random constants "
          f"(seed 0), BN statistics calibrated on the card in {calib_s:.2f} "
          f"s; compute {backend.compute_dtype}, host TF1 resize", flush=True)
    slide3 = pyramid_slide(seed=1)
    step = int(DET_WINDOW_UM / DET_MPP * (1 - DET_OVERLAP))
    images = np.stack([
        slide3.read_region_array((step * i, step * j), 3,
                                 (DET_WINDOW_PX, DET_WINDOW_PX))
        for j in range(2) for i in range(5)][:DET_BATCH])
    backend.detect_batch(images)  # warm-up, not counted
    (rh, rw), model, anchors = backend._model_for(DET_WINDOW_PX,
                                                  DET_WINDOW_PX)
    check((rh, rw) == OD_RESIZED, f"resized window {(rh, rw)}")
    resize_ms = []
    for _ in range(3):
        t0 = time.perf_counter()
        x = backend.resize_host(images, rh, rw)
        resize_ms.append((time.perf_counter() - t0) * 1e3)
    x = x.cuda()
    with torch.no_grad():
        feats, obj, deltas = model.first_stage(x)
        rpn_boxes, rpn_scores = model.rpn_candidates(obj, deltas, anchors)
        proposals, prop_scores = model.propose(obj, deltas, anchors)
        cls_logits, box_enc = model.box_classifier(feats, proposals)
        cand_boxes, cand_scores = model.detection_candidates(
            proposals, prop_scores, cls_logits, box_enc)
    del feats
    check(tuple(rpn_scores.shape) == OD_K3_SHAPES["rpn"][:2]
          and tuple(cand_scores.shape) == OD_K3_SHAPES["second"][:2],
          f"OD-API NMS problems {tuple(rpn_scores.shape)}, "
          f"{tuple(cand_scores.shape)}")
    k3 = {"od_api rpn proposals": nms_case(
              rpn_boxes, rpn_scores, cfg.max_proposals,
              cfg.rpn_nms_threshold),
          "od_api second candidates": nms_case(
              cand_boxes, cand_scores, cfg.max_detections,
              cfg.second_nms_threshold, cfg.second_score_threshold)}
    for label, r in k3.items():
        print_nms_case(label, r, name_power)
    del rpn_boxes, rpn_scores, cand_boxes, cand_scores

    # ---- the timed scan at full width, bf16, host TF1 resize ----
    detector = GlomusDetector(
        "OPT_PAS", "", str(WORK), str(WORK / "od_api"), "_smoke",
        window_size=DET_WINDOW_UM, overlap_ratio=DET_OVERLAP,
        conf_threshold=0.0, batch_size=DET_BATCH)
    recorder = RecordingBackend(backend)
    torch.cuda.reset_peak_memory_stats()
    od_s, od_launches, od_rows = scan(detector, recorder, slide3,
                                      WORK / "od_api_kernel.csv")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    n_windows = math.prod(detector.calc_window_size()[2:4])
    batches = math.ceil(n_windows / DET_BATCH)
    check(len(recorder.results) == batches,
          f"OD-API: {len(recorder.results)} batches read, want {batches}")
    check(od_launches == 2 * batches,
          f"OD-API: K3 launched {od_launches} times, want {2 * batches}")
    n_det = check_detections(recorder.results, cfg.max_detections)
    check(n_det > 0 and od_rows > 0, "OD-API: no detections")
    top = max(float(r[1].max()) for r in recorder.results)
    print(f"OD-API detector slice bf16 batch {DET_BATCH}: {n_windows} "
          f"windows of {DET_WINDOW_PX}x{DET_WINDOW_PX} resized to {rh}x{rw} "
          f"in {batches} batches, {od_s:.4f} s/slide, "
          f"{n_windows / od_s:.2f} windows/s, K3 launches {od_launches}, "
          f"peak memory {peak_gb:.3f} GB, {n_det} detections (top score "
          f"{top:.4f}), {od_rows} CSV rows; host TF1 resize "
          f"{np.median(resize_ms):.1f} ms per batch of {DET_BATCH} (median "
          f"of 3) | {name_power}", flush=True)

    # ---- the readback: batch A read after batch B is launched ----
    with torch.inference_mode(), tf32(True, False):
        packed_a = pack_detections(model.detect(x, anchors))
        handle_a = readback(packed_a)
        handle_b = backend.detect_batch_submit(images[::-1].copy())
        got_a = read_host(handle_a)
        want_a = packed_a.cpu().numpy()
    check(isinstance(handle_a, tuple) and isinstance(handle_b, tuple)
          and handle_a[0].is_pinned(), "the readback handle on the card")
    check(np.array_equal(got_a, want_a),
          "the event-based readback differs from .cpu()")
    backend.read_detections(handle_b)
    print(f"OD-API readback: a pinned copy and an event per batch; batch A "
          f"read after batch B was launched equals A's .cpu() copy "
          f"({got_a.shape}, float32) | {name_power}", flush=True)

    # ---- host resize with K3, the plain NMS, the device resize: turns ----
    others = {
        "plain NMS": ODAPIDetectorBackend(params=backend.params,
                                          num_classes=1,
                                          batch_size=DET_BATCH,
                                          kernel_nms=False),
        "device resize": ODAPIDetectorBackend(params=backend.params,
                                              num_classes=1,
                                              batch_size=DET_BATCH,
                                              device_resize=True)}
    for other in others.values():
        other.detect_batch(images)  # warm-up
    forms = dict(others, **{"host resize, K3": backend})
    turns = {"host resize, K3": [od_s], "plain NMS": [],
             "device resize": []}
    # the timed scan above is K3's first turn
    for name in ("plain NMS", "device resize", "device resize", "plain NMS",
                 "host resize, K3"):
        secs, n_launch, _ = scan(detector, forms[name], slide3,
                                 WORK / f"od_api_{name[:5]}.csv")
        want = 0 if name == "plain NMS" else od_launches
        check(n_launch == want, f"OD-API {name}: K3 launched {n_launch}")
        turns[name].append(secs)
    faster = "device" if np.median(turns["device resize"]) < \
        np.median(turns["host resize, K3"]) else "host"
    print("OD-API detector slice bf16 s/slide in turns: " + "; ".join(
        f"{name} " + ", ".join(f"{s_:.4f}" for s_ in ts)
        + f" (median {np.median(ts):.4f})" for name, ts in turns.items())
        + f"; the faster resize here: {faster} | {name_power}", flush=True)
    del others, forms

    # ---- the cv2 resize takes no other path where cv2 is missing ----
    cv2_backend = ODAPIDetectorBackend(params=backend.params, num_classes=1,
                                       batch_size=DET_BATCH,
                                       compat_tf1_resize=False)
    if importlib.util.find_spec("cv2") is None:
        try:
            cv2_backend.detect_batch(images)
        except ImportError as e:
            print(f"OD-API compat_tf1_resize=False with the host resize "
                  f"raises here (no cv2): {type(e).__name__}: {e}",
                  flush=True)
        else:
            check(False, "compat_tf1_resize=False ran without cv2")
    else:
        import cv2

        cv2_backend.detect_batch(images)
        print(f"OD-API compat_tf1_resize=False: cv2 {cv2.__version__} is "
              f"present here and resized the windows", flush=True)
    del cv2_backend

    f32_same_with_and_without_k3(
        lambda kernel_nms: ODAPIDetectorBackend(
            params=backend.params, num_classes=1, batch_size=DET_BATCH,
            compute_dtype="float32", kernel_nms=kernel_nms),
        images, name_power, "OD-API detector")
    print_conv_trace("bf16 OD-API detector batch", backend, images, model,
                     x, anchors, name_power)
    return k3, od_launches


# ---------------- the end-to-end pipeline (gseg-e2e) ----------------
class HostSpans:
    """Host seconds and calls of chosen functions, summed over threads:
    each is wrapped in place with a timer; ``restore`` puts the originals
    back."""

    def __init__(self):
        self.lock = threading.Lock()
        self.spans = {}
        self.patched = []

    def wrap(self, owner, attr: str, label) -> None:
        """``label``: a span name, or a function of the call's arguments
        that returns one."""
        orig = getattr(owner, attr)
        name_of = label if callable(label) else (lambda *a, **k: label)

        def timed(*args, **kwargs):
            t0 = time.perf_counter()
            try:
                return orig(*args, **kwargs)
            finally:
                dt = time.perf_counter() - t0
                key = name_of(*args, **kwargs)
                with self.lock:
                    s_, n_ = self.spans.get(key, (0.0, 0))
                    self.spans[key] = (s_ + dt, n_ + 1)

        self.patched.append((owner, attr, attr in vars(owner), orig))
        setattr(owner, attr, timed)

    def take(self) -> dict:
        with self.lock:
            out, self.spans = self.spans, {}
        return out

    def restore(self) -> None:
        for owner, attr, own, orig in reversed(self.patched):
            if own:
                setattr(owner, attr, orig)
            else:
                delattr(owner, attr)
        self.patched = []


def read_label(reader: str):
    """A span label for each region read of ``reader`` ("native" or
    "python"): crops at level 0, detection windows and overlay reads."""
    def label(slide, location, level, size):
        if level == 0:
            return f"crop reads (level 0, {reader})"
        if tuple(size) == (DET_WINDOW_PX, DET_WINDOW_PX):
            return f"window reads (level 3, {reader})"
        return f"overlay reads (level 3, {reader})"
    return label


def wrap_slide_reads(spans: "HostSpans") -> None:
    """Time the region reads of both slide readers, labelled by reader."""
    spans.wrap(NativeSlide, "read_region_array", read_label("native"))
    spans.wrap(Slide, "read_region_array", read_label("python"))


def python_reads(spans: dict) -> list:
    """The spans of a run's reads that went through the Python reader."""
    return sorted(k for k in spans if k.endswith(", python)"))


def e2e_slide(path: Path) -> float:
    """Write the e2e smoke slide with the port's synthetic writer; returns
    the seconds it took."""
    t0 = time.perf_counter()
    level3 = pyramid_slide(seed=1).level3
    base = np.repeat(np.repeat(level3, 8, axis=0), 8, axis=1)
    path.parent.mkdir(parents=True, exist_ok=True)
    write_pyramidal_tiff(str(path), base, mpp=DET_MPP, objective_power=40.0,
                         compression=E2E_COMPRESSION)
    return time.perf_counter() - t0


def log_rows(out: Path):
    """The timing log's rows: (patient, time, detect_time)."""
    lines = (out / "OPT_PAS_GlomusMergedList__log.csv").read_text() \
        .splitlines()
    check(lines[0] == "file,time,detect_time,timestamp", "timing log header")
    return [(ln.split(",")[0].strip('"'), float(ln.split(",")[1]),
             float(ln.split(",")[2])) for ln in lines[1:]]


def artifacts(out: Path) -> dict:
    """Every artifact file of a run's output directory -> its bytes, the
    timing log without its times."""
    files = {}
    for p in sorted(out.rglob("*")):
        if p.is_file() and not p.name.endswith("_log.csv"):
            files[str(p.relative_to(out))] = p.read_bytes()
    files["log"] = [r[0] for r in log_rows(out)]
    return files


def e2e_phase(ckpt_dir: Path, name_power: str) -> dict:
    """The end-to-end pipeline through the CLI's ``build_pipeline`` at its
    defaults, on a written pyramidal TIFF read by the port's ``open_slide``:
    two slides pipelined and serial (byte-identical artifacts; the
    serial run traced), the detect and segment split, ``--no_json`` and
    ``--device_resize`` on one slide, host spans, peak memory and the K1
    and K3 launches of the pipelined run.  Returns that run's launches and
    times."""
    have = {m: importlib.util.find_spec(m) is not None for m in ("PIL", "cv2")}
    version = {m: __import__(m).__version__ if found else "missing"
               for m, found in have.items()}
    print(f"e2e: PIL {version['PIL']}, cv2 {version['cv2']}, "
          f"/usr/include/jpeglib.h present "
          f"{os.path.exists('/usr/include/jpeglib.h')}; slide compression "
          f"{E2E_COMPRESSION}; labelme JSONs written | {name_power}",
          flush=True)
    check(have["PIL"] and have["cv2"], "the e2e phase needs PIL (JPEG "
          "tiles, labelme PNGs) and cv2 (contours, the overlay)")
    root = WORK / "e2e"
    shutil.rmtree(root, ignore_errors=True)
    path = root / "data" / "E2E.tiff"
    write_s = e2e_slide(path)
    # every command below opens it with wsi.open_slide: the native reader
    with wsi.open_slide(str(path)) as s_:
        check(isinstance(s_, NativeSlide), f"e2e: open_slide gave "
              f"{type(s_).__name__}, not the native reader")
        width, height = s_.dimensions
        print(f"e2e slide: {path.stat().st_size / 1e6:.1f} MB written in "
              f"{write_s:.2f} s by wsi/synthetic.py ({E2E_COMPRESSION}, "
              f"256-px tiles), opened by wsi.open_slide as "
              f"{type(s_).__name__}; level 0 {s_.dimensions}, "
              f"{s_.level_count} levels, downsamples "
              f"{[round(d) for d in s_.level_downsamples]}, mpp "
              f"{s_.properties['openslide.mpp-x']}, objective "
              f"{s_.properties['openslide.objective-power']} | {name_power}",
              flush=True)
    jobs = [(str(path), pid) for pid in E2E_JOBS]
    t0 = time.perf_counter()
    consts = random_od_api_consts(E2E_DETECTOR_SEED)
    backend = ODAPIDetectorBackend(consts=consts, batch_size=DET_BATCH)
    print(f"e2e detector: ODAPIDetectorBackend on random_od_api_consts("
          f"{E2E_DETECTOR_SEED}), bf16, host TF1 resize, batch {DET_BATCH}; "
          f"built in {time.perf_counter() - t0:.2f} s", flush=True)
    args = build_parser().parse_args([
        "--model", str(root), "--target_list", str(root / "targets.txt"),
        "--data_dir", str(root / "data"),
        "--segmentation_weights_dir", str(ckpt_dir)])
    pipe = build_pipeline(args, backend)
    ens = pipe.segmenter.ensemble
    check(ens.engine == "packed" and ens.fuse_level3
          and ens.config.batch_size == 32
          and ens.config.compute_dtype == "bfloat16"
          and pipe.segmenter.transfer == "flat"
          and (pipe.detect_conf, pipe.merge_conf, pipe.merge_overlap)
          == (0.2, 0.9, 0.35), "the CLI defaults")

    spans = HostSpans()
    wrap_slide_reads(spans)
    spans.wrap(backend, "resize_host", "TF1 resize (detector)")
    spans.wrap(backend, "read_detections", "detection reads (wait)")
    spans.wrap(ens, "read_maps", "class-map reads (wait)")
    spans.wrap(fused_module, "pack_crops_flat", "crop packing")
    spans.wrap(fused_module, "postprocess_nearest_host",
               "full-res maps (JSON path)")
    spans.wrap(e2e_module, "build_labelme_doc", "labelme docs (contours, "
               "PNG)")
    spans.wrap(FusedEndToEnd, "_write_overlay", "overlay (reads, blend, "
               "JPG)")
    detected, canvases = [], []
    merge_boxes, segment_slide = pipe.merge_boxes, pipe.segmenter.segment_slide

    def counting_merge(detections, *a):
        detected.append(len(detections))
        return merge_boxes(detections, *a)

    def keeping_segment(slide, merged, **kw):
        canvas = segment_slide(slide, merged, **kw)
        canvases.append((merged, canvas))
        return canvas

    pipe.merge_boxes = counting_merge
    pipe.segmenter.segment_slide = keeping_segment
    spans.wrap(pipe, "merge_boxes", "box merge")

    def run(name, pipeline, json_dir=True, n_jobs=len(jobs)):
        out = root / name
        FusedEndToEnd.prepare_output(str(out), "OPT_PAS")
        results = []
        detected.clear()
        canvases.clear()
        spans.take()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        esp_block_fused.launches = esp_block_padded.launches = 0
        nms.launches = 0
        t0 = time.perf_counter()
        ok = pipe.run_slides(
            jobs[:n_jobs], str(out),
            json_dir=str(out / "json") if json_dir else None,
            pipeline=pipeline,
            on_result=lambda *r: results.append(r))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        for pid, _, error, _ in results:
            if error is not None:
                raise RuntimeError(f"e2e {name}: slide {pid} failed") \
                    from error
        check(ok == n_jobs, f"e2e {name}: {ok} of {n_jobs} slides")
        return {"out": out, "wall": wall,
                "secs": [r[3] for r in results],
                "launches": (esp_block_fused.launches,
                             esp_block_padded.launches, nms.launches),
                "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
                "spans": spans.take(), "log": log_rows(out),
                "detected": list(detected), "canvases": list(canvases)}

    def print_run(label, r):
        split = ", ".join(f"{t:.3f} ({d:.3f} + {t - d:.3f})"
                          for _, t, d in r["log"])
        print(f"e2e {label}: {len(r['secs'])} slides in {r['wall']:.3f} s "
              f"wall ({r['wall'] / len(r['secs']):.3f} s/slide); per slide "
              f"(on_result) " + ", ".join(f"{s_:.3f}" for s_ in r["secs"])
              + f" s; timing log time (detect + segment and emit) {split}; "
              f"(K1, K2, K3) launches {r['launches']}; peak memory "
              f"{r['peak_gb']:.3f} GB | {name_power}", flush=True)
        print("  host spans (s, calls, summed over threads): " + "; ".join(
            f"{k} {v[0]:.3f}/{v[1]}" for k, v in
            sorted(r["spans"].items(), key=lambda kv: -kv[1][0])),
            flush=True)

    try:
        # the earlier phases ran the detector and the packed engine at
        # these shapes: no warm-up run
        main_run = run("pipelined", True)
        # the serial run is the traced one: the device works under 2% of
        # the time, so the profiler's per-launch cost is lost in the noise
        serial = {}
        prof = trace(lambda: serial.update(run("serial", False)))
        # one slide each without the JSONs: the device-side /8 gather,
        # then the same with the windows resized on the card
        no_json = run("no_json", False, json_dir=False, n_jobs=1)
        pipe.backend = ODAPIDetectorBackend(params=backend.params,
                                            num_classes=1,
                                            batch_size=DET_BATCH,
                                            device_resize=True)
        device_resize = run("device_resize", False, json_dir=False,
                            n_jobs=1)
        pipe.backend = backend
    finally:
        spans.restore()
        del pipe.merge_boxes, pipe.segmenter.segment_slide

    # ---- what came out ----
    rows = [ln.split(",") for ln in (main_run["out"] /
            "OPT_PAS_GlomusMergedList_.csv").read_text().splitlines()]
    merged = {pid: [r for r in rows if r[1] == pid] for pid in E2E_JOBS}
    sizes = np.asarray([(int(r[5]) - int(r[3])) * (int(r[6]) - int(r[4]))
                        for r in rows])
    sides = np.asarray([(int(r[5]) - int(r[3]), int(r[6]) - int(r[4]))
                        for r in rows])
    n_windows = main_run["spans"]["window reads (level 3, native)"][1] \
        // len(jobs)
    for label, r in (("pipelined", main_run), ("serial", serial),
                     ("--no_json", no_json),
                     ("--device_resize", device_resize)):
        check(not python_reads(r["spans"]), f"e2e {label}: reads through "
              f"the Python reader {python_reads(r['spans'])}")
    print(f"e2e slides: {n_windows} windows each, detections "
          f"{main_run['detected']}, merged boxes "
          f"{[len(v) for v in merged.values()]}; crop sides (w, h) min "
          f"{sides.min(0).tolist()}, median {np.median(sides, 0).tolist()}, "
          f"max {sides.max(0).tolist()}, crop areas median "
          f"{float(np.median(sizes)):.0f} px (random weights: the detector "
          f"decides the boxes; none filtered or clipped) | {name_power}",
          flush=True)
    check(max(len(v) for v in merged.values()) >= 32,
          "no slide has a full crop batch of 32: change the detector seed")
    for merged_boxes, canvas in main_run["canvases"]:
        boxes = [[int(v) for v in r[:4]] + [r[4]] for r in merged_boxes]
        check(canvas.shape == (height // 8, width // 8), "e2e canvas shape")
        check(int(canvas.max()) < 5, "e2e canvas classes")
        check(outside_boxes_is_background(canvas, boxes),
              "e2e canvas has labels outside every box")
    want_k3 = 2 * math.ceil(n_windows / DET_BATCH) * len(E2E_JOBS)
    want_k1 = 40 * sum(math.ceil(len(v) / 32) for v in merged.values())
    k1_n, k2_n, k3_n = main_run["launches"]
    check(k1_n > 0 and k3_n > 0, f"e2e launches {main_run['launches']}")
    check((k1_n, k2_n, k3_n) == (want_k1, 0, want_k3),
          f"e2e (K1, K2, K3) launches {main_run['launches']}, want "
          f"{(want_k1, 0, want_k3)}")

    # ---- pipelined against serial: byte-identical artifacts ----
    a, b = artifacts(main_run["out"]), artifacts(serial["out"])
    check(a.keys() == b.keys(), "e2e: pipelined and serial files differ")
    differ = [k for k in a if a[k] != b[k]]
    check(not differ, f"e2e: pipelined and serial differ in {differ[:5]}")
    for pid, v in merged.items():
        n_json = len([k for k in a if k.startswith(f"json/{pid}/")])
        check(n_json == len(v), f"e2e {pid}: {n_json} JSONs for "
                                f"{len(v)} boxes")
    first = [ln for ln in a["OPT_PAS_GlomusMergedList_.csv"].splitlines(True)
             if ln.split(b",")[1] == E2E_JOBS[0].encode()]
    check(artifacts(no_json["out"])["OPT_PAS_GlomusMergedList_.csv"]
          == b"".join(first), "e2e --no_json: other merged boxes")
    same_px = float((no_json["canvases"][0][1]
                     == main_run["canvases"][0][1]).mean())
    print(f"e2e pipelined and serial: {len(a) - 1} artifact files "
          f"(merged CSV, labelme JSONs, overlay "
          f"JPGs) byte-identical, timing-log rows equal apart from the "
          f"times; --no_json: merged CSV identical, canvas pixels equal to "
          f"the JSON run's {same_px:.6f} | {name_power}", flush=True)
    for label, r in (("pipelined (main path)", main_run),
                     ("serial (traced)", serial),
                     ("serial --no_json", no_json),
                     ("serial --no_json --device_resize", device_resize)):
        print_run(label, r)
    print_trace(f"e2e serial run ({len(jobs)} slides, JSON path)", prof,
                name_power)
    return {"launches": main_run["launches"], "wall": main_run["wall"],
            "serial_wall": serial["wall"], "slide": path,
            "params": backend.params, "consts": consts,
            "n_windows": n_windows,
            "detected": main_run["detected"][0],
            "merged_csv": main_run["out"] / "OPT_PAS_GlomusMergedList_.csv",
            "no_json_out": no_json["out"]}


# ---------------- the commands around the e2e path ----------------
def write_model_dir(params, folder: Path) -> Path:
    """The e2e detector's parameters as a model directory that
    ``cli/detect.load_backend`` reads (``od_api_detector.ckpt.pth``)."""
    folder.mkdir(parents=True, exist_ok=True)
    torch.save({"od_api_params": params, "num_classes": 1, "od_config": {}},
               folder / "od_api_detector.ckpt.pth")
    return folder


def merged_boxes(rows) -> list:
    """Merged-CSV rows (strings) -> their (x1, y1, x2, y2, score)."""
    return [[float(v) for v in r.split(",")[3:8]] for r in rows]


def staged_detect_phase(e2e: dict, model_dir: Path, name_power: str) -> dict:
    """``gseg-detect`` then ``gseg-merge`` (``cli/detect.main``,
    ``cli/merge.main``) on the e2e slide at the e2e operating point: the K3
    launches of the scan, the detections and the merged boxes against the
    e2e phase's, and ``--resume`` leaving both outputs byte-identical."""
    root = WORK / "staged"
    shutil.rmtree(root, ignore_errors=True)
    slide_dir = root / "data" / "02_PAS" / E2E_JOBS[0]
    slide_dir.mkdir(parents=True)
    (slide_dir / e2e["slide"].name).symlink_to(e2e["slide"])
    targets = root / "targets.txt"
    targets.write_text(f"{E2E_JOBS[0]}/{e2e['slide'].name}\n")
    out = root / "out"
    argv = ["--model", str(model_dir), "--target_list", str(targets),
            "--data_dir", str(root / "data"), "--staining", "OPT_PAS",
            "--output_dir", str(out), "--window_size", str(DET_WINDOW_UM),
            "--overlap_ratio", str(DET_OVERLAP), "--conf_threshold", "0.2"]
    csv_path, log_path = (out / "OPT_PAS_GlomusList.csv",
                          out / "OPT_PAS_GlomusList_log.csv")
    torch.cuda.synchronize()
    nms.launches = 0
    t0 = time.perf_counter()
    detect_cli.main(argv)
    wall = time.perf_counter() - t0
    k3 = nms.launches
    want_k3 = 2 * math.ceil(e2e["n_windows"] / DET_BATCH)
    check(k3 == want_k3, f"staged detect: K3 launched {k3} times, want "
                         f"{want_k3}")
    rows = csv_path.read_text().splitlines()
    check(len(rows) == e2e["detected"], f"staged detect: {len(rows)} "
          f"detections, the e2e phase {e2e['detected']}")
    scan_s = float(log_path.read_text().splitlines()[1].split(",")[1])
    before = csv_path.read_bytes(), log_path.read_bytes()
    detect_cli.main(argv + ["--resume"])
    check((csv_path.read_bytes(), log_path.read_bytes()) == before,
          "staged detect --resume changed the CSV or the timing log")
    merge_cli.main(["--staining", "OPT_PAS", "--target_list", str(targets),
                    "--detected_list", str(csv_path),
                    "--output_dir", str(root / "merged"),
                    "--conf_threshold", "0.9", "--data_dir",
                    str(root / "data"), "--overlap_threshold", "0.35"])
    staged = merged_boxes((root / "merged" / "OPT_PAS_GlomusMergedList_.csv")
                          .read_text().splitlines())
    fused = merged_boxes([r for r in e2e["merged_csv"].read_text()
                          .splitlines() if r.split(",")[1] == E2E_JOBS[0]])
    check(len(staged) == len(fused) > 0, f"staged merge: {len(staged)} "
          f"boxes, the e2e phase {len(fused)}")
    check(np.allclose(sorted(staged), sorted(fused), rtol=1e-6, atol=0),
          "staged merge: other boxes than the e2e phase's")
    print(f"staged detect (gseg-detect, then gseg-merge 0.9 / 0.35): "
          f"{e2e['n_windows']} windows, K3 launches {k3}, {len(rows)} "
          f"detections and {len(staged)} merged boxes, equal to the e2e "
          f"phase's; --resume skipped the slide, CSV and timing log "
          f"byte-identical; scan {scan_s:.3f} s/slide (timing log), main "
          f"{wall:.3f} s with the detector's load | {name_power}",
          flush=True)
    return {"k3": k3, "scan_s": scan_s, "wall": wall}


def staged_segment_tree(root: Path) -> dict:
    """The example-data layout of the staged chain around a written GT
    slide (``SEG_SLIDE_HW``): the pyramid under ``data/02_PAS/<patient>/``,
    drawn at level 3 and expanded 8x in blocks; a Pascal-VOC XML at ds8;
    one labelme GT JSON per glomerulus, sized to its margin frame (as
    ``tests/test_pipeline_integration.py``'s fixture writes them); a
    detection CSV of the GT boxes grown by 8 px and the two false
    positives; and the target list."""
    rng = np.random.RandomState(5)
    h0, w0 = SEG_SLIDE_HW
    rows, cols = SEG_GRID
    ch, cw = h0 // 8 // rows, w0 // 8 // cols
    centers = [(j * cw + cw // 2 - 4 + int(rng.randint(-6, 7)),
                i * ch + ch // 2 + int(rng.randint(-6, 7)),
                int(rng.randint(SEG_RADII[0], SEG_RADII[1] + 1)))
               for i in range(rows) for j in range(cols)]
    level3, _ = pas_like_image(h0 // 8, w0 // 8, seed=5, centers=centers)
    base = np.repeat(np.repeat(level3, 8, axis=0), 8, axis=1)
    pid = SEG_PATIENT
    slide_dir = root / "data" / "02_PAS" / pid
    (slide_dir / "annotations").mkdir(parents=True)
    write_pyramidal_tiff(str(slide_dir / f"{pid}.tiff"), base, mpp=DET_MPP,
                         objective_power=40.0, compression=E2E_COMPRESSION)
    margin = int(round(20.0 / DET_MPP))
    gt_boxes, objects, docs = [], [], root / "seg_annotation" / pid
    docs.mkdir(parents=True)
    for cx, cy, r in centers:
        cx0, cy0, r0 = cx * 8 + 4, cy * 8 + 4, r * 8
        x1, y1 = (cx0 - r0 - 16) // 8 * 8, (cy0 - r0 - 16) // 8 * 8
        x2, y2 = (cx0 + r0 + 16) // 8 * 8, (cy0 + r0 + 16) // 8 * 8
        fx1, fy1, fx2, fy2 = x1 - margin, y1 - margin, x2 + 2 * margin, \
            y2 + 2 * margin
        check(fx1 >= 0 and fy1 >= 0 and fx2 <= w0 and fy2 <= h0,
              "staged segment: a GT margin frame leaves the slide")
        gt_boxes.append((x1, y1, x2, y2))
        objects.append(f"  <object><name>glomerulus</name><bndbox><xmin>"
                       f"{x1 // 8}</xmin><ymin>{y1 // 8}</ymin><xmax>"
                       f"{x2 // 8}</xmax><ymax>{y2 // 8}</ymax></bndbox>"
                       f"</object>\n")
        theta = np.linspace(0, 2 * np.pi, 40)
        doc = {"shapes": [{"label": "glomerulus", "points": [
                   [float(cx0 - fx1 + r0 * np.cos(t)),
                    float(cy0 - fy1 + r0 * np.sin(t))] for t in theta],
                   "line_color": None, "fill_color": None}],
               "imagePath": "frame.png",
               "imageData": img_arr_to_b64(base[fy1:fy2, fx1:fx2])}
        (docs / f"xmin{x1 // 8}_ymin{y1 // 8}_xmax{x2 // 8}_ymax{y2 // 8}"
                f".json").write_text(json.dumps(doc))
    del base
    (slide_dir / "annotations" / f"OPT_PAS_{pid}_{pid}_pw40_ds8.xml") \
        .write_text("<annotation>\n" + "".join(objects) + "</annotation>\n")
    row = f'"S","{pid}","{pid}.tiff",new,2026-01-01T00:00:00,'
    detections = [row + f"{x1 - 8},{y1 - 8},{x2 + 8},{y2 + 8},0.97"
                  for x1, y1, x2, y2 in gt_boxes]
    detections += [row + ",".join(map(str, fp)) + ",0.95"
                   for fp in SEG_FALSE_POSITIVES]
    (root / "detections.csv").write_text("\n".join(detections) + "\n")
    (root / "targets.txt").write_text(f"{pid}/{pid}\n")
    return {"gt_boxes": gt_boxes, "radii": [r * 8 for *_, r in centers]}


def staged_k1_case(fold1: Path, name_power: str) -> dict:
    """K1 against its plain version at ``gseg-segment``'s shape: one fold's
    first level-3 block, batch 8, f32 with TF32 off; timed in turns."""
    ops = [torch.from_numpy(v) for v in pack_esp_weights(
        load_espnet_state_dict(str(fold1)), "encoder.level3.0.")]
    shape = (SEG_BATCH,) + K1_SHAPE[1:]
    with tf32(False, False):
        x = torch.randn(shape, generator=torch.Generator(device="cuda")
                        .manual_seed(9), device="cuda")
        case = block_case("K1 staged segment", esp_block_fused,
                          esp_block_plain, x, ops, math.prod(shape[:3]))
    print_block_case("K1 esp_block_fused (gseg-segment's level 3, one fold)",
                     case, name_power)
    return case


def staged_segment_phase(ckpt_dir: Path, name_power: str) -> dict:
    """The staged segment-and-evaluate chain on a written GT slide through
    the port's commands: ``gseg-merge`` (0.9 / 0.35), ``gseg-make-seg-data``
    in GT mode, ``gseg-segment`` with the e2e phase's fold-1 checkpoint at
    the command's defaults (f32, ``--precision highest``, batch 8) with
    ``--engine fused`` and then with the default ``--engine xla``, and
    ``gseg-eval-wsi`` in GT mode on the fused run's JSONs.  Holds K1 to its
    plain version at this path's shape in f32 first, then checks recall,
    the K1 launches of each run (the count set to 0 just before and read
    just after), the two engines' class maps against each other, the pixel
    counts and the TSV; prints stage seconds, crops/s, host spans and peak
    memory.  Returns the fused run's K1 launches and the K1 case."""
    import cv2

    root = WORK / "staged_segment"
    shutil.rmtree(root, ignore_errors=True)
    stage_s = {}
    t0 = time.perf_counter()
    tree = staged_segment_tree(root)
    stage_s["slide, XML, GT JSONs, CSV"] = time.perf_counter() - t0
    pid, n_gt = SEG_PATIENT, len(tree["gt_boxes"])
    fold1 = ckpt_dir / "espnet_fold1.pth"
    mean, std = FOLD_NORMALIZATION[1]

    k1_case = staged_k1_case(fold1, name_power)

    t0 = time.perf_counter()
    merge_cli.main(["--staining", "OPT_PAS", "--target_list",
                    str(root / "targets.txt"), "--detected_list",
                    str(root / "detections.csv"), "--output_dir",
                    str(root / "merged"), "--conf_threshold", "0.9",
                    "--data_dir", str(root / "data"), "--overlap_threshold",
                    "0.35"])
    stage_s["gseg-merge"] = time.perf_counter() - t0
    merged_csv = root / "merged" / "OPT_PAS_GlomusMergedList_.csv"
    n_merged = len(merged_csv.read_text().splitlines())
    check(n_merged == n_gt + len(SEG_FALSE_POSITIVES),
          f"staged segment: {n_merged} merged boxes, want "
          f"{n_gt + len(SEG_FALSE_POSITIVES)}")

    scans = []
    scan_files = seg_data_module.SegDataGenerator.scan_files

    def recording_scan(self):
        rows = scan_files(self)
        scans.append(rows)
        return rows

    seg_out = root / "seg_data"
    seg_data_module.SegDataGenerator.scan_files = recording_scan
    t0 = time.perf_counter()
    try:
        seg_data_cli.main([
            "--staining", "OPT_PAS", "--merged_detection_result_csv",
            str(merged_csv), "--target_list", str(root / "targets.txt"),
            "--wsi_dir", str(root / "data" / "02_PAS"),
            "--segmentation_gt_json_dir", str(root / "seg_annotation"),
            "--object_detection_gt_xml_dir", str(root / "data"),
            "--output_dir", str(seg_out)])
    finally:
        seg_data_module.SegDataGenerator.scan_files = scan_files
    stage_s["gseg-make-seg-data"] = time.perf_counter() - t0
    check(len(scans) == 1 and len(scans[0]) == 1,
          f"staged segment: scan_files ran {scans}")
    _, recall, hits, gts, dets = scans[0][0]
    crops = sorted((seg_out / "org_image" / pid).glob("*.PNG"))
    labels = sorted((seg_out / "label" / "all" / pid).glob("*.PNG"))
    check((recall, hits, gts, dets) == (1.0, n_gt, str(n_gt), str(n_merged))
          and len(crops) == len(labels) == n_merged,
          f"staged segment: scan_files {scans[0][0]}, {len(crops)} crops, "
          f"{len(labels)} labels, {n_merged} merged boxes")
    from PIL import Image

    areas = {}
    for crop in crops:
        with Image.open(crop) as im:
            areas[crop.name] = im.size[0] * im.size[1]

    spans = HostSpans()
    spans.wrap(cv2, "imread", "PNG reads")
    spans.wrap(segment_module, "preprocess_host", "cv2 preprocess")
    spans.wrap(segment_module.EspnetSegmenter, "__init__",
               "segmenter load (checkpoint, model)")
    spans.wrap(segment_module.EspnetSegmenter, "submit_net_res",
               "submits (preprocess, upload, launch)")
    spans.wrap(segment_module.EspnetSegmenter, "read_net_res",
               "waits for results")
    spans.wrap(segment_module, "build_labelme_doc",
               "JSON documents (contours, PNG, b64)")
    spans.wrap(json, "dump", "JSON writes")
    spans.wrap(cv2, "addWeighted", "overlay blends")
    spans.wrap(cv2, "imwrite", "image writes (overlay JPG, org PNG, "
               "combined PNG)")
    runs = {}
    try:
        for engine in ("fused", "xla"):
            pred = root / f"pred_{engine}"
            argv = ["--rgb_data_dir", str(seg_out / "org_image"),
                    "--label_data_dir", str(seg_out / "label" / "all"),
                    "--savedir", str(pred), "--weights", str(fold1),
                    "--decoder", "--cityFormat", "--json_image_data",
                    "classmap", "--colored", "--overlay",
                    "--mean", *map(str, mean), "--std", *map(str, std)]
            if engine == "fused":
                argv += ["--engine", "fused"]
            spans.take()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            esp_block_fused.launches = 0
            t0 = time.perf_counter()
            segment_cli.main(argv)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            runs[engine] = {"pred": pred, "wall": wall,
                            "launches": esp_block_fused.launches,
                            "peak_gb": torch.cuda.max_memory_allocated()
                            / 1e9, "spans": spans.take()}
            stage_s[f"gseg-segment {engine}"] = wall
    finally:
        spans.restore()

    t0 = time.perf_counter()
    tsv = root / "eval" / "seg_data_output.tsv"
    eval_wsi_cli.main([
        "--staining", "OPT_PAS", "--merged_detection_result_csv",
        str(merged_csv), "--target_list", str(root / "targets.txt"),
        "--wsi_dir", str(root / "data" / "02_PAS"),
        "--segmentation_pred_json_dir", str(runs["fused"]["pred"]),
        "--object_detection_gt_xml_dir", str(root / "data"),
        "--segmentation_gt_json_dir", str(root / "seg_annotation"),
        "--segmentation_gt_png_dir", str(seg_out / "label" / "all"),
        "--output_file", str(tsv), "--output_dir", str(root / "eval")])
    stage_s["gseg-eval-wsi"] = time.perf_counter() - t0

    # ---- what came out ----
    want_k1 = 8 * math.ceil(n_merged / SEG_BATCH)
    launches = (runs["fused"]["launches"], runs["xla"]["launches"])
    check(launches == (want_k1, 0), f"staged segment: K1 launches (fused, "
          f"xla) {launches}, want ({want_k1}, 0)")
    same = total = 0
    for engine, r in runs.items():
        jsons = sorted((r["pred"] / pid).glob("*.json"))
        check(len(jsons) == n_merged, f"staged segment {engine}: "
              f"{len(jsons)} JSONs for {n_merged} crops")
        rows = (r["pred"] / "summary_pixel.csv").read_text().splitlines()[1:]
        check(len(rows) == n_merged, f"staged segment {engine}: {len(rows)}"
              " pixel-count rows")
        for row in rows:
            cells = row.split(",")
            area = areas[cells[1].replace(".png", ".PNG")]
            check(sum(int(v) for v in cells[2:]) == area,
                  f"staged segment {engine}: {cells[1]}'s pixel counts do "
                  f"not sum to its area {area}")
    classes_seen = set()
    for path in sorted((runs["fused"]["pred"] / pid).glob("*.json")):
        a = img_b64_to_arr(json.loads(path.read_text())["imageData"])
        b = img_b64_to_arr(json.loads(
            (runs["xla"]["pred"] / pid / path.name).read_text())["imageData"])
        check(a.shape == b.shape, f"staged segment: {path.name} shapes")
        same += int((a == b).sum())
        total += a.size
        classes_seen |= set(np.unique(a).tolist())
    agree = same / total
    check(agree >= 0.999, f"staged segment: fused and xla class maps agree "
                          f"on {agree:.6f} of pixels")
    text = tsv.read_text().split("\n")
    miou = float(text[-1].split("\t")[-1])
    check(len(text) == 2 and text[0].startswith(pid + "\t")
          and text[1].startswith("total\t") and math.isfinite(miou),
          f"staged segment: TSV {text}")
    overlays = sorted(p.name for p in (root / "eval").glob("*.jpg"))
    check(overlays == [f"{pid}_gt.jpg", f"{pid}_pred.jpg"],
          f"staged segment: eval overlays {overlays}")

    sides = np.asarray([(b[2] - b[0] + 16, b[3] - b[1] + 16)
                        for b in tree["gt_boxes"]])
    print(f"staged segment (gseg-merge 0.9 / 0.35, gseg-make-seg-data GT "
          f"mode, gseg-segment fold 1 at the command's defaults: f32, "
          f"precision highest, batch {SEG_BATCH}, 512x1024; gseg-eval-wsi GT "
          f"mode, window 2400): slide {SEG_SLIDE_HW[1]}x{SEG_SLIDE_HW[0]} at "
          f"{DET_MPP} um/px, {n_gt} glomeruli (radius {min(tree['radii'])} "
          f"to {max(tree['radii'])} px), {n_merged} merged boxes and crops "
          f"(sides {sides.min()} to {sides.max()} px; 2 false positives), "
          f"recall {recall}; K1 launches (fused, xla) {launches}; fused and "
          f"xla class maps equal on {agree:.6f} of {total} pixels; classes "
          f"{sorted(classes_seen)}; TSV total mIoU {miou:.6f} (random "
          f"weights) | {name_power}", flush=True)
    print("staged segment stage seconds: " + ", ".join(
        f"{k} {v:.3f}" for k, v in stage_s.items()) + f" | {name_power}",
        flush=True)
    for engine, r in runs.items():
        load = r["spans"].get("segmenter load (checkpoint, model)",
                              (0.0, 0))[0]
        print(f"staged segment gseg-segment --engine {engine}: {n_merged} "
              f"crops in {r['wall']:.3f} s ({n_merged / r['wall']:.2f} "
              f"crops/s; {n_merged / (r['wall'] - load):.2f} crops/s after "
              f"the {load:.3f} s load), K1 launches {r['launches']}, peak "
              f"memory {r['peak_gb']:.3f} GB | {name_power}", flush=True)
        print("  host spans (s, calls): " + "; ".join(
            f"{k} {v[0]:.3f}/{v[1]}" for k, v in
            sorted(r["spans"].items(), key=lambda kv: -kv[1][0])),
            flush=True)
    return {"launches": launches[0], "k1": k1_case, "stage_s": stage_s,
            "walls": {e: r["wall"] for e, r in runs.items()},
            "slide": root / "data" / "02_PAS" / pid / f"{pid}.tiff",
            "gt_boxes": tree["gt_boxes"]}


def warmup_phase(ckpt_dir: Path, model_dir: Path, name_power: str) -> dict:
    """``gseg-warmup`` in a fresh process, the kernels already built: its
    exit code, its ``warmed:`` line, its wall time and when each of its
    lines came, beside what the build took this run."""
    cmd = [sys.executable, "-m", "glomeruli_segmentation_tpu_torch.cli.warmup",
           "--segmentation_weights_dir", str(ckpt_dir), "--model",
           str(model_dir), "--window_sizes", str(DET_WINDOW_PX),
           "--transfer", "flat"]
    t0 = time.perf_counter()
    lines = []
    with subprocess.Popen(cmd, cwd=ROOT, stdout=subprocess.PIPE,
                          stderr=subprocess.PIPE, text=True) as proc:
        err = []
        reader = threading.Thread(target=lambda: err.extend(proc.stderr))
        reader.start()
        for line in proc.stdout:
            lines.append((time.perf_counter() - t0, line.rstrip("\n")))
        proc.wait(timeout=600)
        reader.join()
    wall = time.perf_counter() - t0
    check(proc.returncode == 0, f"gseg-warmup exited {proc.returncode}: "
          + "".join(err)[-3000:])
    warmed = [text for _, text in lines if text.startswith("warmed:")]
    want = ("warmed: " + ", ".join(f"ensemble@512:flat{k}/8"
                                   for k in (5, 6, 7, 8, 9))
            + f", detector@{DET_WINDOW_PX}")
    check(warmed == [want], f"gseg-warmup printed {warmed}, want {want}")
    nvcc_s = {name: sec for name, (sec, _) in _build.build_log.items()}
    print(f"gseg-warmup (fresh process, kernels built): exit 0, {wall:.2f} s "
          f"wall (interpreter and CUDA start, 5-fold ensemble and detector "
          f"load, 10 ensemble forwards at batch 32 and 1 detector batch); "
          f"lines at " + "; ".join(f"{t:.2f} s {text[:60]!r}"
                                   for t, text in lines)
          + f"; this run's nvcc build, which a warm-up saves a fresh "
          f"server: " + ", ".join(f"{k} {v:.2f} s" for k, v in nvcc_s.items())
          + f" | {name_power}", flush=True)
    return {"wall": wall, "nvcc_s": nvcc_s}


def serve_phase(e2e: dict, ckpt_dir: Path, model_dir: Path,
                name_power: str) -> dict:
    """``gseg-serve`` (``cli/serve.main``) in this process at the CLI's
    defaults with ``--no_json``: four tickets (two patients, a second
    ticket for the first, a missing slide) through pipelined waves, with
    the K1, K2 and K3 counts set to 0 before and read after.  Checks the
    spool, the log rows, the artifacts against the e2e phase's
    ``--no_json`` run and the launches."""
    root = WORK / "serve"
    shutil.rmtree(root, ignore_errors=True)
    spool, out = root / "spool", root / "out"
    spool.mkdir(parents=True)
    tickets = [("t1.json", e2e["slide"], E2E_JOBS[0]),
               ("t2.json", e2e["slide"], E2E_JOBS[1]),
               ("t3.json", e2e["slide"], E2E_JOBS[0]),
               ("t4.json", root / "missing.tiff", "E2E-9")]
    written = {}
    base = time.time()
    for i, (name, slide_path, pid) in enumerate(tickets):
        (spool / name).write_text(json.dumps(
            {"slide_path": str(slide_path), "patient_id": pid}))
        os.utime(spool / name, (base + i, base + i))
        written[name] = time.time()
    argv = ["--model", str(model_dir), "--segmentation_weights_dir",
            str(ckpt_dir), "--spool_dir", str(spool), "--output_dir",
            str(out), "--no_json", "--max_slides", "4",
            "--poll_interval", "0.2"]
    check(resolve_slide_pipeline(serve_cli.build_parser()
                                           .parse_args(argv)),
          "the server's --slide_pipeline auto resolved to serial")
    emitted, served_from = {}, []
    emit, serve = serve_module.SlideServer._emit, \
        serve_module.SlideServer.serve

    def timed_emit(self, row):
        emitted[row["ticket"]] = time.time()
        emit(self, row)

    def timed_serve(self, *a, **kw):
        served_from.append(time.time())
        return serve(self, *a, **kw)

    serve_module.SlideServer._emit = timed_emit
    serve_module.SlideServer.serve = timed_serve
    torch.cuda.synchronize()
    # the allocator's cache of the earlier phases would count as reserved
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    esp_block_fused.launches = esp_block_padded.launches = 0
    nms.launches = 0
    t0 = time.time()
    try:
        serve_cli.main(argv)
    finally:
        serve_module.SlideServer._emit = emit
        serve_module.SlideServer.serve = serve
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = (esp_block_fused.launches, esp_block_padded.launches,
                nms.launches)

    rows = [json.loads(ln) for ln in
            (out / "serve_log.jsonl").read_text().splitlines()]
    for r in rows:
        check(not (r["status"] == "failed" and r["ticket"] != "t4.json"),
              f"serve: good ticket {r['ticket']} failed: {r.get('error')}")
    listing = {d: sorted(os.listdir(spool / d))
               for d in ("active", "done", "failed")}
    check(listing == {"active": [], "done": ["t1.json", "t2.json",
                                             "t3.json"],
                      "failed": ["t4.json"]}, f"serve: spool {listing}")
    check("error" in json.loads((spool / "failed" / "t4.json").read_text()),
          "serve: the failed ticket has no error field")
    check([(r["ticket"], r["status"]) for r in rows]
          == [("t1.json", "done"), ("t2.json", "done"),
              ("t4.json", "failed"), ("t3.json", "skipped_already_done")],
          f"serve: log rows {[(r['ticket'], r['status']) for r in rows]}")

    csv_rows = (out / "OPT_PAS_GlomusMergedList_.csv").read_text() \
        .splitlines(True)
    first = [r for r in csv_rows if r.split(",")[1] == E2E_JOBS[0]]
    second = [r for r in csv_rows if r.split(",")[1] == E2E_JOBS[1]]
    want_csv = (e2e["no_json_out"] / "OPT_PAS_GlomusMergedList_.csv") \
        .read_bytes()
    check("".join(first).encode() == want_csv,
          "serve: E2E-1's merged rows differ from the e2e --no_json run's")
    check([r.replace(f",{E2E_JOBS[1]},", f",{E2E_JOBS[0]},", 1)
           for r in second] == first,
          "serve: E2E-2's rows differ from E2E-1's beyond the patient")
    check(len(first) + len(second) == len(csv_rows), "serve: other rows")
    overlay = f"{E2E_JOBS[0]}_pred.jpg"
    check((out / overlay).read_bytes()
          == (e2e["no_json_out"] / overlay).read_bytes(),
          f"serve: {overlay} differs from the e2e --no_json run's")
    want = (40 * math.ceil(len(first) / 32) * 2, 0,
            2 * 2 * math.ceil(e2e["n_windows"] / DET_BATCH))
    check(launches == want, f"serve (K1, K2, K3) launches {launches}, want "
                            f"{want}")
    first_done = min(emitted[r["ticket"]] for r in rows
                     if r["status"] == "done")
    print(f"gseg-serve (--no_json, the CLI's other defaults: pipelined "
          f"waves of 4, packed engine batch 32, bf16, OD-API host TF1 "
          f"resize): 4 tickets in {wall:.3f} s; server start (main to its "
          f"first spool scan, models loaded) {served_from[0] - t0:.3f} s; "
          f"main to the first done row {first_done - t0:.3f} s; per ticket "
          f"(sec; ticket write to its log row) "
          + ", ".join(f"{r['ticket']} {r['status']} {r.get('sec', '-')}; "
                      f"{emitted[r['ticket']] - written[r['ticket']]:.3f}"
                      for r in rows)
          + f"; (K1, K2, K3) launches {launches}; artifacts of {E2E_JOBS[0]}"
          f" byte-identical to the e2e --no_json run's; host RSS "
          f"{serve_module._rss_kb() / 1e6:.3f} GB; device memory after the "
          f"run: allocated {torch.cuda.memory_allocated() / 1e9:.3f} GB; "
          f"during it: max allocated "
          f"{torch.cuda.max_memory_allocated() / 1e9:.3f} GB, max reserved "
          f"{torch.cuda.max_memory_reserved() / 1e9:.3f} GB | {name_power}",
          flush=True)
    return {"launches": launches, "wall": wall}


# ---------------- the SegFormer/GTCS model family ----------------
# operator -> group of the traced SegFormer batch (the kernels carry
# library names, so the operator that launched each one names its group)
SEGFORMER_OP_GROUPS = (
    ("attention matmuls (q.k^T, .v)", ("aten::bmm",)),
    ("linear layers (matmuls)", ("aten::addmm", "aten::mm")),
    ("softmax", ("aten::_softmax",)),
    ("LayerNorm", ("aten::native_layer_norm",)),
    ("convolutions", ("conv",)),
    ("GELU", ("aten::gelu",)),
)


def segformer_groups(prof: dict) -> dict:
    """Device ms of a traced SegFormer run by ``SEGFORMER_OP_GROUPS``; the
    rest is other elementwise work (residual adds, casts, copies, the
    head's upsample and BatchNorm, the normalisation)."""
    groups = {}
    for op, (ms, _) in prof["ops_ms"].items():
        group = next((g for g, keys in SEGFORMER_OP_GROUPS
                      if any(k in op for k in keys)),
                     "other elementwise (adds, casts, copies, upsample, BN)")
        groups[group] = groups.get(group, 0.0) + ms
    return groups


def segformer_model_phase(name_power: str, device="cuda") -> dict:
    """Seeded port-initialised SegFormer weights at mit-b0 and mit-b4,
    written as the trainer's ``flax_model.pth`` and read back (both
    geometries recovered by ``config_from_state_dict``); the b0 forward on
    the card against the same module on the CPU in float32 (TF32 off); ms
    per batch by CUDA events, crops/s, TFLOP/s and peak memory for b0 at
    batch 32 and b4 at batch 8 in float32 and bf16, the bf16-vs-f32 argmax
    agreement, and a traced b0 batch by operator group.  Returns the
    checkpoints' directories and the b4 state dict."""
    from torch.utils.flop_counter import FlopCounterMode

    # the SegFormer modules import cv2 and PIL, as the JAX package's do
    from glomeruli_segmentation_tpu_torch.pipeline import (
        fused_segformer as fused_segformer_module,
    )

    root = WORK / "segformer"
    shutil.rmtree(root, ignore_errors=True)
    models = {}
    for name, cfg in SEGFORMER_CONFIGS.items():
        sd = random_segformer_state_dict(cfg, SEGFORMER_SEED,
                                         SEGFORMER_CLASSIFIER_SCALE)
        (root / name).mkdir(parents=True)
        save_flax_checkpoint(sd, str(root / name / "flax_model.pth"),
                             cfg.num_labels)
        loaded, labels = fused_segformer_module.load_segformer_checkpoint(
            str(root / name))
        check(config_from_state_dict(loaded) == cfg and labels == 5,
              f"SegFormer {name}: the written checkpoint gives "
              f"{config_from_state_dict(loaded)}, {labels} labels")
        check(loaded.keys() == sd.keys()
              and all(torch.equal(loaded[k], sd[k]) for k in sd),
              f"SegFormer {name}: the written checkpoint's tensors differ")
        models[name] = {"sd": loaded, "dir": root / name, "params": sum(
            v.numel() for k, v in loaded.items()
            if not k.endswith("num_batches_tracked"))}
    print("SegFormer checkpoints (flax_model.pth, the trainer's format, "
          "read back by load_segformer_checkpoint): " + ", ".join(
              f"{name} {m['params'] / 1e6:.3f} M parameters, geometry "
              f"recovered" for name, m in models.items())
          + f" | {name_power}", flush=True)

    # ---- the b0 forward: card against CPU, float32 ----
    batch, atol, min_agree = SEGFORMER_PARITY
    cfg0, sd0 = SEGFORMER_CONFIGS["mit-b0"], models["mit-b0"]["sd"]
    x = torch.randn(batch, SEGFORMER_INPUT, SEGFORMER_INPUT, 3,
                    generator=torch.Generator().manual_seed(1))
    cpu_model = Segformer(cfg0).eval()
    cpu_model.load_state_dict(sd0, strict=True)
    t0 = time.perf_counter()
    with torch.no_grad():
        want = cpu_model(x)
    cpu_s = time.perf_counter() - t0
    del cpu_model
    card_model = Segformer(cfg0)
    card_model.load_state_dict(sd0, strict=True)
    card_model.to(device).eval()
    with torch.no_grad(), tf32(False, False):
        got = card_model(x.to(device)).cpu()
    err = float((got - want).abs().max())
    agree = float((got.argmax(-1) == want.argmax(-1)).float().mean())
    print(f"SegFormer mit-b0 f32 (TF32 off) {tuple(x.shape)}: card against "
          f"CPU max abs logit diff {err:.3e} (tolerance {atol}), argmax "
          f"agreement {agree:.6f} (at least {min_agree}); largest |logit| "
          f"{float(want.abs().max()):.3f}; classes "
          f"{torch.bincount(want.argmax(-1).flatten(), minlength=5).tolist()}"
          f"; CPU forward {cpu_s:.2f} s | {name_power}", flush=True)
    check(err <= atol and agree >= min_agree,
          f"SegFormer mit-b0: card and CPU disagree ({err}, {agree})")
    del card_model, x, got, want

    # ---- ms per batch, crops/s, TFLOP/s, peak memory ----
    timings = {}
    for name, cfg in SEGFORMER_CONFIGS.items():
        n = SEGFORMER_BATCH[name]
        xb = torch.randn(n, SEGFORMER_INPUT, SEGFORMER_INPUT, 3,
                         generator=torch.Generator(device=device)
                         .manual_seed(2), device=device)
        argmax = {}
        for dtype in (torch.float32, torch.bfloat16):
            model = Segformer(cfg, dtype=dtype)
            model.load_state_dict(models[name]["sd"], strict=True)
            model.to(device).eval()
            with torch.no_grad(), tf32(False, False):
                with FlopCounterMode(display=False) as counter:
                    model(xb[:1])
                flop = counter.get_total_flops()
                torch.cuda.synchronize()
                torch.cuda.empty_cache()
                torch.cuda.reset_peak_memory_stats()
                ms = cuda_ms(lambda: model(xb), iters=5, warmup=2)
                argmax[dtype] = model(xb).argmax(-1)
                if name == "mit-b0" and dtype == torch.float32:
                    prof = trace(lambda: model(xb))
            timings[(name, dtype)] = {
                "ms": ms, "crops_s": n / ms * 1e3, "gflop": flop / 1e9,
                "tflops": flop * n / ms / 1e9,
                "peak_gb": torch.cuda.max_memory_allocated() / 1e9}
            del model
        timings[(name, "agree")] = float(
            (argmax[torch.float32] == argmax[torch.bfloat16]).float().mean())
        del xb, argmax
    for name in SEGFORMER_CONFIGS:
        for dtype in (torch.float32, torch.bfloat16):
            t = timings[(name, dtype)]
            print(f"SegFormer {name} {str(dtype)[6:]} batch "
                  f"{SEGFORMER_BATCH[name]} at {SEGFORMER_INPUT}x"
                  f"{SEGFORMER_INPUT}: {t['ms']:.3f} ms per batch (CUDA "
                  f"events, 5 launches), {t['crops_s']:.1f} crops/s, "
                  f"{t['gflop']:.2f} GFLOP per crop (matmuls and convs, "
                  f"torch's flop counter), {t['tflops']:.1f} TFLOP/s, peak "
                  f"memory {t['peak_gb']:.3f} GB | {name_power}", flush=True)
        print(f"SegFormer {name}: bf16 and f32 argmax agree on "
              f"{timings[(name, 'agree')]:.6f} of pixels | {name_power}",
              flush=True)
    groups = segformer_groups(prof)
    print(f"profile SegFormer mit-b0 f32 batch {SEGFORMER_BATCH['mit-b0']} "
          f"(traced run): wall {prof['wall_ms']:.1f} ms, device busy "
          f"{prof['device_busy_ms']:.1f} ms, idle share "
          f"{prof['idle_share']:.3f}; by operator group (ms): " + ", ".join(
              f"{k} {v:.2f}" for k, v in
              sorted(groups.items(), key=lambda kv: -kv[1]))
          + f" | {name_power}", flush=True)
    for kname, ms, count in prof["top"]:
        print(f"  {ms:9.2f} ms {count:6d}x  {kname}")
    return {"b0_dir": models["mit-b0"]["dir"],
            "b4_sd": models["mit-b4"]["sd"], "timings": timings,
            "groups": groups}


def segformer_e2e_phase(e2e: dict, model_dir: Path, b0_dir: Path,
                        name_power: str) -> dict:
    """``gseg-e2e --segformer_checkpoint`` (``cli/e2e.main``) with the
    mit-b0 checkpoint directory, the e2e phase's OD-API detector (its model
    directory) and slide: once with ``--no_json`` (the device gather) and
    once at the default (mode-'L' label PNGs through ``on_crop``), the
    K1, K2 and K3 counts set to 0 before and read after each.  Checks the
    launches, the PNGs, the two canvases against each other, the merged
    CSV against the e2e phase's and the overlay; prints s/slide, host spans
    and peak memory.  Returns the launches of the ``--no_json`` run."""
    import cv2
    from PIL import Image

    from glomeruli_segmentation_tpu_torch.pipeline import (
        fused_segformer as fused_segformer_module,
    )

    root = WORK / "segformer_e2e"
    shutil.rmtree(root, ignore_errors=True)
    pid = E2E_JOBS[0]
    slide_dir = root / "data" / "02_PAS" / pid
    slide_dir.mkdir(parents=True)
    (slide_dir / e2e["slide"].name).symlink_to(e2e["slide"])
    targets = root / "targets.txt"
    targets.write_text(f"{pid}/{e2e['slide'].name}\n")
    want_csv = "".join(r for r in e2e["merged_csv"].read_text()
                       .splitlines(True) if r.split(",")[1] == pid)
    seg_cls = fused_segformer_module.SegformerSlideSegmenter
    segment_slide, canvases = seg_cls.segment_slide, []

    def keeping_segment(self, *a, **kw):
        canvas = segment_slide(self, *a, **kw)
        canvases.append(canvas)
        return canvas

    spans = HostSpans()
    wrap_slide_reads(spans)
    spans.wrap(cv2, "resize", lambda src, dsize, *a, **k: (
        "crop resizes (cv2, uint8)" if tuple(dsize) == (
            SEGFORMER_INPUT, SEGFORMER_INPUT) else "other cv2 resizes"))
    spans.wrap(seg_cls, "predict_full", "full-res maps (numpy upsample, "
               "argmax)")
    spans.wrap(Image.Image, "save", "PNG writes")
    spans.wrap(fused_segformer_module, "read_host", "result reads (wait)")
    spans.wrap(FusedEndToEnd, "_write_overlay", "overlay (reads, blend, JPG)")
    seg_cls.segment_slide = keeping_segment
    runs = {}
    try:
        for name, extra in (("no_json", ["--no_json"]), ("png", [])):
            out = root / name
            spans.take()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            esp_block_fused.launches = esp_block_padded.launches = 0
            nms.launches = 0
            t0 = time.perf_counter()
            e2e_cli.main(["--model", str(model_dir), "--target_list",
                          str(targets), "--data_dir", str(root / "data"),
                          "--output_dir", str(out), "--segformer_checkpoint",
                          str(b0_dir), *extra])
            torch.cuda.synchronize()
            runs[name] = {"out": out, "wall": time.perf_counter() - t0,
                          "launches": (esp_block_fused.launches,
                                       esp_block_padded.launches,
                                       nms.launches),
                          "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
                          "spans": spans.take(), "log": log_rows(out)}
    finally:
        seg_cls.segment_slide = segment_slide
        spans.restore()

    # ---- what came out ----
    want_k3 = 2 * math.ceil(e2e["n_windows"] / DET_BATCH)
    for name, r in runs.items():
        check(r["launches"] == (0, 0, want_k3), f"SegFormer e2e {name}: "
              f"(K1, K2, K3) launches {r['launches']}, want (0, 0, "
              f"{want_k3})")
        got_csv = (r["out"] / "OPT_PAS_GlomusMergedList_.csv").read_text()
        check(got_csv == want_csv, f"SegFormer e2e {name}: the merged CSV "
              f"differs from the ESPNet e2e phase's")
        check((r["out"] / f"{pid}_pred.jpg").is_file(),
              f"SegFormer e2e {name}: no overlay")
        check(not python_reads(r["spans"]), f"SegFormer e2e {name}: reads "
              f"through the Python reader {python_reads(r['spans'])}")
    rows = [ln.split(",") for ln in want_csv.splitlines()]
    pngs = sorted((runs["png"]["out"] / "json" / pid).glob("*.PNG"))
    check(len(pngs) == len(rows), f"SegFormer e2e: {len(pngs)} PNGs for "
          f"{len(rows)} merged boxes")
    for r in rows:
        x1, y1, x2, y2 = (int(v) for v in r[3:7])
        path = (runs["png"]["out"] / "json" / pid /
                f"xmin{x1 // 8}_ymin{y1 // 8}_xmax{x2 // 8}_ymax{y2 // 8}"
                f".PNG")
        with Image.open(path) as im:
            check(im.mode == "L" and im.size == (x2 - x1, y2 - y1)
                  and int(np.asarray(im).max()) < 5,
                  f"SegFormer e2e: {path.name} is {im.mode} {im.size}")
    check(len(canvases) == 2 and np.array_equal(canvases[0], canvases[1]),
          "SegFormer e2e: the device-gather and on_crop canvases differ")
    classes = np.bincount(canvases[0].ravel(), minlength=5).tolist()
    print(f"SegFormer e2e (gseg-e2e --segformer_checkpoint, mit-b0 at the "
          f"CLI's defaults: input {SEGFORMER_INPUT}, crop batch 32, f32 with "
          f"TF32 off; the e2e phase's OD-API detector and slide): "
          f"{len(rows)} merged boxes, the merged CSV equal to the ESPNet e2e "
          f"phase's; {len(pngs)} mode-L label PNGs of the boxes' sizes; the "
          f"--no_json (device gather) and PNG (host upsample) canvases "
          f"byte-identical, class pixel counts {classes} | {name_power}",
          flush=True)
    for name, r in runs.items():
        _, sec, detect_s = r["log"][0]
        print(f"SegFormer e2e {name}: {sec:.3f} s/slide (timing log; detect "
              f"{detect_s:.3f}), main {r['wall']:.3f} s with the loads; "
              f"(K1, K2, K3) launches {r['launches']}; peak memory "
              f"{r['peak_gb']:.3f} GB | {name_power}", flush=True)
        print("  host spans (s, calls, summed over threads): " + "; ".join(
            f"{k} {v[0]:.3f}/{v[1]}" for k, v in
            sorted(r["spans"].items(), key=lambda kv: -kv[1][0])),
            flush=True)
    return {"launches": runs["no_json"]["launches"],
            "secs": {n: r["log"][0][1] for n, r in runs.items()}}


def staged_gtcs_phase(b4_sd: dict, name_power: str) -> dict:
    """The staged GTCS chain on the staged segment phase's GT slide
    (``staged_segment_tree``): crops over the 20 um margin frame under
    ``rgb/<specimen>/`` and GTCS label PNGs (glomerulus, its tuft) under
    ``label/gtcs/<specimen>/`` as the JAX package's fixture lays them out,
    a merged CSV of the GT boxes, and a training directory with two mit-b4
    checkpoints and a ``log.txt``; then ``gseg-segformer-test --save_image
    1``, ``gseg-eval-wsi-gtcs --evaluate`` on its ``seg/`` and, as a
    control, on the GT labels.  Checks the checkpoint chosen, the rows,
    the pixel counts, a finite mIoU, the TSV's total row and the control's
    accuracy."""
    import cv2

    from glomeruli_segmentation_tpu_torch.cli import (
        eval_wsi_gtcs as gtcs_eval_cli,
        segformer_test as gtcs_test_cli,
    )
    from glomeruli_segmentation_tpu_torch.pipeline import (
        fused_segformer as fused_segformer_module,
        segformer_test as gtcs_test_module,
    )

    root = WORK / "staged_gtcs"
    shutil.rmtree(root, ignore_errors=True)
    stage_s = {}
    t0 = time.perf_counter()
    tree = staged_segment_tree(root)
    stage_s["slide, XML, GT JSONs"] = time.perf_counter() - t0
    pid = SEG_PATIENT
    margin = int(round(20.0 / DET_MPP))       # the evaluator's MARGIN_UM
    data = root / "gtcs" / GTCS_SITE / GTCS_DATE
    rgb, labels = data / "rgb" / pid, data / "label" / "gtcs" / pid
    rgb.mkdir(parents=True)
    labels.mkdir(parents=True)
    t0 = time.perf_counter()
    rows, areas = [], {}
    with wsi.open_slide(str(root / "data" / "02_PAS" / pid / f"{pid}.tiff")
                        ) as slide:
        for (x1, y1, x2, y2), r in zip(tree["gt_boxes"], tree["radii"]):
            fw, fh = x2 - x1 + 2 * margin, y2 - y1 + 2 * margin
            crop = slide.read_region_array((x1 - margin, y1 - margin), 0,
                                           (fw, fh))
            name = f"xmin{x1}_ymin{y1}_xmax{x2}_ymax{y2}.PNG"
            cv2.imwrite(str(rgb / name), crop[:, :, ::-1])
            yy, xx = np.mgrid[:fh, :fw]
            d2 = ((yy - (fh - 1) / 2) ** 2 + (xx - (fw - 1) / 2) ** 2)
            label = np.zeros((fh, fw), np.uint8)
            label[d2 < r * r] = 1                      # glomerulus
            label[d2 < (r // 2) ** 2] = 2              # tuft
            lblsave(str(labels / name), label)
            areas[name] = fw * fh
            rows.append(f'"S","{pid}","{pid}.tiff",{x1},{y1},{x2},{y2},0.97')
    merged_csv = root / "merged.csv"
    merged_csv.write_text("\n".join(rows) + "\n")
    stage_s["crops and GTCS labels"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    run = root / "models" / GTCS_SITE / "segformer" / "b4" / "fold1"
    cfg4 = SEGFORMER_CONFIGS["mit-b4"]
    for n, sd in ((1, b4_sd), (2, random_segformer_state_dict(
            cfg4, SEGFORMER_SEED + 1, SEGFORMER_CLASSIFIER_SCALE))):
        (run / f"checkpoint-{n}").mkdir(parents=True)
        save_flax_checkpoint(sd, str(run / f"checkpoint-{n}" /
                                     "flax_model.pth"), cfg4.num_labels)
    # the best eval_mean_iou is not the last epoch's: checkpoint-1
    (run / "log.txt").write_text("{'eval_mean_iou': 0.31, 'epoch': 1}\n"
                                 "{'eval_mean_iou': 0.29, 'epoch': 2}\n")
    stage_s["checkpoints"] = time.perf_counter() - t0

    loaded = []
    load = fused_segformer_module.load_segformer_checkpoint

    def recording_load(path):
        loaded.append(path)
        return load(path)

    spans = HostSpans()
    spans.wrap(gtcs_test_module.ResizedGlomerularDataset, "get",
               "crop reads and feature_extract (PNG, cv2, normalise)")
    spans.wrap(gtcs_test_module, "mean_iou", "per-crop mean_iou")
    spans.wrap(gtcs_test_module, "save_triptych", "triptychs and seg PNGs")
    fused_segformer_module.load_segformer_checkpoint = recording_load
    report = root / "report"
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    try:
        gtcs_test_cli.main([
            "--fold", "1", "--target_site", GTCS_SITE, "--model_site",
            GTCS_SITE, "--data_date", GTCS_DATE, "--model_base_path",
            str(root / "models"), "--pretrained_model", "segformer/b4",
            "--report_root_path", str(report), "--data_root",
            str(root / "gtcs"), "--save_image", "1"])
    finally:
        fused_segformer_module.load_segformer_checkpoint = load
        spans.restore()
    torch.cuda.synchronize()
    stage_s["gseg-segformer-test"] = time.perf_counter() - t0
    test_spans = spans.take()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    check(len(loaded) == 1 and Path(loaded[0]).parent.name == "checkpoint-1"
          and gtcs_test_module.search_best_checkpoint(str(run))
          == "checkpoint-1", f"staged GTCS: loaded {loaded}, want the "
          f"checkpoint-1 that log.txt names")
    out = report / GTCS_SITE / GTCS_SITE / GTCS_DATE / "segformer" / "b4" \
        / "fold1"
    pixel_rows = (out / "pred_summary_pixel.csv").read_text().splitlines()
    check(len(pixel_rows) == len(rows) + 1, f"staged GTCS: "
          f"{len(pixel_rows) - 1} pixel rows for {len(rows)} crops")
    for line in pixel_rows[1:]:
        cells = line.split(",")
        check(float(cells[2]) + float(cells[3]) == areas[cells[1]],
              f"staged GTCS: {cells[1]}'s pixel counts do not sum to its "
              f"area {areas[cells[1]]}")
    report_rows = dict(ln.split(",")[:2] for ln in
                       (out / "summary_report.csv").read_text().splitlines())
    miou = float(report_rows["overall_mean_iou"])
    check(math.isfinite(miou), f"staged GTCS: overall_mean_iou {miou}")
    segs = sorted((out / "seg" / pid).glob("*.PNG"))
    triptychs = sorted((out / pid).glob("*.PNG"))
    check(len(segs) == len(triptychs) == len(rows),
          f"staged GTCS: {len(segs)} seg PNGs, {len(triptychs)} triptychs")

    totals = {}
    for name, pred_dir in (("prediction", out / "seg"),
                           ("control", data / "label" / "gtcs")):
        t0 = time.perf_counter()
        gtcs_eval_cli.main([
            "--staining", "OPT_PAS", "--merged_detection_result_csv",
            str(merged_csv), "--target_list", str(root / "targets.txt"),
            "--wsi_dir", str(root / "data" / "02_PAS"),
            "--seg_pred_image_dir", str(pred_dir), "--seg_gt_image_dir",
            str(data / "label" / "gtcs"), "--output_dir",
            str(root / f"eval_{name}"), "--evaluate"])
        stage_s[f"gseg-eval-wsi-gtcs ({name})"] = time.perf_counter() - t0
        text = (root / f"eval_{name}" / "seg_data_output.tsv").read_text() \
            .split("\n")
        total = text[-1].split("\t")
        check(len(text) == 2 and text[0].startswith(pid + "\t")
              and total[0] == "total" and len(total) == 7,
              f"staged GTCS eval ({name}): TSV {text}")
        totals[name] = total
    control_acc = float(totals["control"][1])
    check(control_acc > 0.999, f"staged GTCS: the control's accuracy "
                               f"{control_acc}")
    print(f"staged GTCS (gseg-segformer-test --save_image 1 at the command's "
          f"defaults: batch 2, input {SEGFORMER_INPUT}, f32 with TF32 off; "
          f"mit-b4, checkpoint-1 of 2 chosen from log.txt; then "
          f"gseg-eval-wsi-gtcs --evaluate, window 2400): {len(rows)} crops "
          f"(frames of {min(areas.values())} to {max(areas.values())} "
          f"px), "
          f"{len(pixel_rows) - 1} pixel rows summing to each label's area, "
          f"overall_mean_iou {miou:.6f} (random weights); TSV total "
          f"(accuracy, mIoU, mDice) prediction {totals['prediction'][1]}, "
          f"{totals['prediction'][4]}, {totals['prediction'][6]}; control "
          f"(GT as the prediction) accuracy {control_acc:.6f}; peak memory "
          f"{peak_gb:.3f} GB | {name_power}", flush=True)
    print("staged GTCS stage seconds: " + ", ".join(
        f"{k} {v:.3f}" for k, v in stage_s.items()) + f" | {name_power}",
        flush=True)
    print("  gseg-segformer-test host spans (s, calls): " + "; ".join(
        f"{k} {v[0]:.3f}/{v[1]}" for k, v in
        sorted(test_spans.items(), key=lambda kv: -kv[1][0])), flush=True)
    return {"stage_s": stage_s, "miou": miou, "control_acc": control_acc}


# ---------------- the native slide reader and gseg-selftest ----------------
def reader_crops(e2e: dict, staged: dict) -> list:
    """(name, slide path, level-0 regions) of the reader phase: every merged
    box of the e2e slide's first job, and the GT slide's 32 glomerulus crops
    over their 20 um margin frames (the staged GTCS phase's crops)."""
    rows = [ln.split(",") for ln in e2e["merged_csv"].read_text()
            .splitlines()]
    boxes = [tuple(int(v) for v in r[3:7]) for r in rows
             if r[1] == E2E_JOBS[0]]
    margin = int(round(20.0 / DET_MPP))
    frames = [(x1 - margin, y1 - margin, x2 + margin, y2 + margin)
              for x1, y1, x2, y2 in staged["gt_boxes"]]
    return [("e2e", e2e["slide"], boxes), ("GT", staged["slide"], frames)]


def threaded_read(cls, path: Path, boxes: list, threads: int) -> float:
    """Wall seconds to read ``boxes`` at level 0 from ``threads`` threads,
    each over its own ``cls`` slide object and every ``threads``-th box."""
    def work(part):
        with cls(str(path)) as slide:
            for x1, y1, x2, y2 in part:
                slide.read_region_array((x1, y1), 0, (x2 - x1, y2 - y1))

    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(threads) as pool:
        list(pool.map(work, [boxes[i::threads] for i in range(threads)]))
    return time.perf_counter() - t0


def reader_phase(crop_sets: list, name_power: str) -> dict:
    """The native reader against the Python one on the main path's crops:
    every crop is read at level 0 by the Python reader and then the native one
    (one slide object each), each call timed, and the bytes must be equal;
    then, for the e2e slide, the same crops from ``READER_THREADS`` threads
    with each reader.  Prints seconds and MP/s per reader and, where the
    slide is NDPI-like, the restart-chunk decodes."""
    out = {}
    for name, path, boxes in crop_sets:
        mpix = sum((x2 - x1) * (y2 - y1) for x1, y1, x2, y2 in boxes) / 1e6
        secs = {"python": 0.0, "native": 0.0}
        with Slide(str(path)) as ps, NativeSlide(str(path)) as ns:
            for x1, y1, x2, y2 in boxes:
                size = (x2 - x1, y2 - y1)
                t0 = time.perf_counter()
                a = ps.read_region_array((x1, y1), 0, size)
                t1 = time.perf_counter()
                b = ns.read_region_array((x1, y1), 0, size)
                t2 = time.perf_counter()
                secs["python"] += t1 - t0
                secs["native"] += t2 - t1
                check(a.shape == (size[1], size[0], 3)
                      and np.array_equal(a, b), f"reader {name}: the "
                      f"readers differ on {(x1, y1, x2, y2)}")
            mode, decodes = ns.ndpi_index_mode(0), ns.chunk_decodes
        layout = (f"NDPI-like, {decodes} restart-chunk decodes" if mode
                  else "tiled: no restart chunks, not NDPI-like")
        r = {"crops": len(boxes), "mpix": mpix, "serial_s": secs}
        text = (f"reader {name}: {len(boxes)} crops, {mpix:.1f} MP at level "
                f"0 ({layout}); native = python bytes on every crop; "
                f"serial: python {secs['python']:.3f} s "
                f"({mpix / secs['python']:.1f} MP/s), native "
                f"{secs['native']:.3f} s ({mpix / secs['native']:.1f} MP/s), "
                f"{secs['python'] / secs['native']:.2f}x")
        if name == "e2e":
            walls = {reader: threaded_read(cls, path, boxes, READER_THREADS)
                     for reader, cls in (("python", Slide),
                                         ("native", NativeSlide))}
            r["threaded_s"] = walls
            text += (f"; {READER_THREADS} threads: python "
                     f"{walls['python']:.3f} s ({mpix / walls['python']:.1f} "
                     f"MP/s), native {walls['native']:.3f} s "
                     f"({mpix / walls['native']:.1f} MP/s), "
                     f"{walls['python'] / walls['native']:.2f}x")
        print(text + f" | {name_power}", flush=True)
        out[name] = r
    return out


def load_graph_writer():
    """``tests/pb_graph_writer.py`` (numpy only): writes constants as a
    frozen GraphDef that ``convert/pb_import.py`` parses."""
    spec = importlib.util.spec_from_file_location(
        "pb_graph_writer", ROOT / "tests" / "pb_graph_writer.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def selftest_phase(slide: Path, consts: dict, params: dict,
                   name_power: str) -> dict:
    """``gseg-selftest`` (``cli/selftest.main``) on the e2e slide and the
    e2e detector's constants (``consts``, assembled into ``params``)
    written as a frozen graph, the K3 count set to
    0 just before and read just after: exit 0 and an ``ok`` verdict; the
    slide checked by both readers (``check_ndpi``'s native branch ran, no
    pixel, property or decode mismatch); the graph parsed back to the e2e
    detector's parameter count; one window through the detector, so K3
    launches twice, (1, 6000 -> 300) and (1, 300 -> 100), and K3 holds to
    ``nms_plain`` on those two problems of that window (taken from
    ``check_pb``'s own backend after the run); the recall check skipped (no
    GT of the reference's example slide here).  Returns the launches, the
    wall time and the two K3 cases."""
    root = WORK / "selftest"
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    graph = root / "frozen_inference_graph.pb"
    t0 = time.perf_counter()
    load_graph_writer().write_graph(consts, str(graph))
    write_s = time.perf_counter() - t0
    verdict_path = root / "verdict.json"
    printed = io.StringIO()
    # keep check_pb's backend and window, to hold K3 against nms_plain on
    # that window's own B = 1 problems after the run
    windows = []
    submit = ODAPIDetectorBackend.detect_batch_submit

    def recording_submit(self, images):
        windows.append((self, images))
        return submit(self, images)

    ODAPIDetectorBackend.detect_batch_submit = recording_submit
    torch.cuda.synchronize()
    nms.launches = 0
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(printed):
            rc = selftest_cli.main(["--ndpi", str(slide), "--pb",
                                    str(graph), "--out", str(verdict_path)])
        torch.cuda.synchronize()
    finally:
        ODAPIDetectorBackend.detect_batch_submit = submit
    wall = time.perf_counter() - t0
    launches = nms.launches
    (root / "stdout.json").write_text(printed.getvalue())
    verdict = json.loads(verdict_path.read_text())
    check(json.loads(printed.getvalue()) == verdict,
          "selftest: the printed verdict differs from the file")
    check(rc == 0 and verdict["ok"] and verdict["checks_run"] == ["ndpi",
                                                                  "pb"],
          f"selftest: exit {rc}, ok {verdict['ok']}, checks "
          f"{verdict['checks_run']}")
    nd, pb = verdict["ndpi"], verdict["pb"]
    check("open_native_s" in nd and "native_reader" not in nd,
          f"selftest: check_ndpi's native branch did not run: "
          f"{nd.get('native_reader')}")
    check(nd["pixel_mismatches"] == nd["decode_errors"]
          == nd["property_mismatches"] == [],
          "selftest: the readers disagree on the e2e slide")
    n_params = sum(int(np.prod(p.shape)) for p in _leaves(params))
    check(pb["assembled_params"] == n_params and pb["contract_violations"]
          == [] and pb["window_source"] == "slide-center",
          f"selftest: check_pb {pb['assembled_params']} parameters (want "
          f"{n_params}), {pb['contract_violations']}, {pb['window_source']}")
    check("skipped" in verdict["recall_vs_real_gt"],
          f"selftest: recall check {verdict['recall_vs_real_gt']}")
    check(launches == 2, f"selftest: K3 launched {launches} times, want 2")
    check(len(windows) == 1 and windows[0][1].shape[0] == 1,
          f"selftest: check_pb ran {len(windows)} detect batches")
    backend, images = windows[0]
    cfg = backend.base_config
    h, w = images.shape[1:3]
    (rh, rw), model, anchors = backend._model_for(h, w)
    x = (backend.resize_host(images, rh, rw) if (rh, rw) != (h, w)
         else torch.from_numpy(np.ascontiguousarray(images)))
    x = x.to(backend.device)
    with torch.no_grad():
        feats, obj, deltas = model.first_stage(x)
        rpn_boxes, rpn_scores = model.rpn_candidates(obj, deltas, anchors)
        proposals, prop_scores = model.propose(obj, deltas, anchors)
        cls_logits, box_enc = model.box_classifier(feats, proposals)
        cand_boxes, cand_scores = model.detection_candidates(
            proposals, prop_scores, cls_logits, box_enc)
    del feats
    check(tuple(rpn_scores.shape) == (1, OD_K3_SHAPES["rpn"][1])
          and tuple(cand_scores.shape) == (1, OD_K3_SHAPES["second"][1]),
          f"selftest NMS problems {tuple(rpn_scores.shape)}, "
          f"{tuple(cand_scores.shape)}")
    k3 = {"selftest rpn proposals": nms_case(
              rpn_boxes, rpn_scores, cfg.max_proposals,
              cfg.rpn_nms_threshold),
          "selftest second candidates": nms_case(
              cand_boxes, cand_scores, cfg.max_detections,
              cfg.second_nms_threshold, cfg.second_score_threshold)}
    for label, r in k3.items():
        print_nms_case(label, r, name_power)
    top = pb["top_detections"][0]
    print(f"selftest (gseg-selftest --ndpi <e2e slide> --pb <e2e detector "
          f"as a frozen graph, {graph.stat().st_size / 1e6:.1f} MB written "
          f"in {write_s:.2f} s>): exit {rc}, ok; check_ndpi: "
          f"{len(nd['regions'])} regions over {nd['level_count']} levels, "
          f"native = python, open python {nd['open_python_s']} s, native "
          f"{nd['open_native_s']} s; check_pb: {pb['graph_constants']} "
          f"constants parsed in {pb['parse_s']} s, {pb['assembled_params']} "
          f"parameters, one 1024-px slide-centre window in {pb['detect_s']} "
          f"s, top score {top['score']}; K3 launches {launches}; recall "
          f"skipped; {wall:.3f} s | {name_power}", flush=True)
    return {"launches": launches, "wall": wall, "k3": k3}


# ---------------- the training slice ----------------
def write_train_tree(root: Path) -> Path:
    """``root/{train,val}/{rgb,label}/<patient>/<crop>.PNG``: PAS-like BGR
    crops (``pas_like_image``) whose glomeruli are labelled 1 with a tuft
    of 2 and, in turn, a crescent (3) or sclerosis (4) cap, as palette
    PNGs; then ``gseg-create-dataset-txt``'s lists."""
    import cv2

    from glomeruli_segmentation_tpu_torch.cli import (
        create_dataset_txt as dataset_txt_cli,
    )

    n_train, n_val, h, w = TRAIN_DATA
    yy, xx = np.mgrid[:h, :w]
    for split, count in (("train", n_train), ("val", n_val)):
        for i in range(count):
            seed = i if split == "train" else 1000 + i
            rng = np.random.RandomState(seed)
            patient = f"P{i % 4}"
            centers = [(int(rng.randint(60, w - 60)),
                        int(rng.randint(60, h - 60)),
                        int(rng.randint(30, 60))) for _ in range(4)]
            rgb, _ = pas_like_image(h, w, seed=seed, centers=centers)
            label = np.zeros((h, w), np.uint8)
            for k, (cx, cy, r) in enumerate(centers):
                d2 = (yy - cy) ** 2 + (xx - cx) ** 2
                label[d2 < r * r] = 1
                label[d2 < (r * r) // 4] = 2
                label[(d2 < r * r) & (yy < cy - r // 2)] = 3 + k % 2
            for kind, array in (("rgb", rgb[:, :, ::-1]), ("label", label)):
                folder = root / split / kind / patient
                folder.mkdir(parents=True, exist_ok=True)
                if kind == "rgb":
                    cv2.imwrite(str(folder / f"crop{i}.PNG"), array)
                else:
                    lblsave(str(folder / f"crop{i}.PNG"), array)
    dataset_txt_cli.main(["--data_dir", str(root)])
    return root


def steady_steps(timings: list) -> dict:
    """Per scale from the trainer's per-step rows (scale, batch shape,
    loader wait s, step s), leaving out the first step of each shape: steps
    counted, mean s/step, images/s over step and wait, the loader-wait
    share of each step."""
    out, seen = {}, set()
    for scale, shape, wait, step in timings:
        if (scale, shape) in seen:
            r = out.setdefault(scale, {"steps": 0, "step_s": 0.0,
                                       "wait_s": 0.0, "images": 0,
                                       "shape": shape})
            r["steps"] += 1
            r["step_s"] += step
            r["wait_s"] += wait
            r["images"] += shape[0]
        seen.add((scale, shape))
    for r in out.values():
        busy = r["step_s"] + r["wait_s"]
        r["s_per_step"] = r["step_s"] / r["steps"]
        r["images_per_s"] = r["images"] / busy
        r["wait_share"] = r["wait_s"] / busy
    return out


def espnet_train_run(root: Path, name: str, extra: list,
                     name_power: str, device: str = "cuda") -> dict:
    """``gseg-train`` through ``cli/train.main`` on the card, the peak
    memory and the epoch loss of each scale recorded around the trainer's
    ``train_epoch``; prints per scale s/step at steady state, images/s,
    the loader-wait share and the peak memory."""
    from glomeruli_segmentation_tpu_torch.cli import train as train_cli
    from glomeruli_segmentation_tpu_torch.train import espnet_train

    peaks, losses = {}, {}
    train_epoch = espnet_train.EspnetTrainer.train_epoch

    def recorded(self, model, optimizer, loader, scale="main"):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        out = train_epoch(self, model, optimizer, loader, scale)
        peaks[scale] = torch.cuda.max_memory_allocated() / 1e9
        losses[scale] = out[0]
        return out

    espnet_train.EspnetTrainer.train_epoch = recorded
    t0 = time.perf_counter()
    try:
        trainer = train_cli.main([
            "--data_dir", str(root), "--cached_data_file",
            str(root / "data.p"), "--savedir", str(WORK / "train" / "espnet"),
            "--classes", str(TRAIN_CLASSES), "--p", str(TRAIN_P), "--q",
            str(TRAIN_Q), "--batch_size", str(TRAIN_BATCH), "--max_epochs",
            "1", "--num_workers", "4", "--device", device, *extra])
    finally:
        espnet_train.EspnetTrainer.train_epoch = train_epoch
    seconds = time.perf_counter() - t0
    savedir = Path(trainer.args.savedir)
    for f in ("checkpoint.pth.tar", "model_1.pth", "acc_0.txt",
              "trainValLog.txt", "mean_std.txt", "model.txt",
              espnet_train.FULL_STATE):
        check((savedir / f).is_file(), f"{name}: {f} not written")
    row = (savedir / "trainValLog.txt").read_text().splitlines()[-1]
    values = [float(v) for v in row.split("\t")]
    check(all(math.isfinite(v) for v in values + list(losses.values())),
          f"{name}: a loss is not finite: {row} {losses}")
    sd = torch.load(savedir / "model_1.pth", weights_only=True)
    model = create_espnet(TRAIN_CLASSES, TRAIN_P, TRAIN_Q,
                          decoder="_dec_" in savedir.name)
    model.load_state_dict(sd, strict=True)
    tar = torch.load(savedir / "checkpoint.pth.tar", weights_only=True)
    check(set(tar) == {"epoch", "arch", "state_dict", "lossTr", "lossVal",
                       "iouTr", "iouVal", "lr"}, f"{name}: {sorted(tar)}")
    steady = steady_steps(trainer.timings)
    for scale in espnet_train.TRAIN_SCALES:
        r = steady[scale]
        print(f"train {name} {scale} batch {tuple(r['shape'])}: "
              f"{r['s_per_step']:.4f} s/step over {r['steps']} steady "
              f"steps, {r['images_per_s']:.2f} images/s, loader wait "
              f"{r['wait_share']:.3f} of each step, peak memory "
              f"{peaks[scale]:.3f} GB, epoch loss {losses[scale]:.4f} | "
              f"{name_power}", flush=True)
    print(f"train {name}: {seconds:.2f} s, {len(trainer.timings)} steps, "
          f"log row {row!r}, {savedir.name}/ written | {name_power}",
          flush=True)
    return {"savedir": savedir, "seconds": seconds, "steady": steady,
            "peaks": peaks}


def host_batch(root: Path, count: int, width: int, height: int):
    """The first ``count`` training crops through the validation pipeline
    at ``width`` x ``height`` (the trainer's normalisation, no random
    transform): an NHWC float32 batch and its int32 labels."""
    import pickle

    from glomeruli_segmentation_tpu_torch.data import transforms as T
    from glomeruli_segmentation_tpu_torch.data.dataset import (
        SegmentationDataset,
    )

    with open(root / "data.p", "rb") as f:
        data = pickle.load(f)
    ds = SegmentationDataset(data["trainIm"][:count],
                             data["trainAnnot"][:count], T.Compose([
                                 T.Normalize(data["mean"], data["std"]),
                                 T.Scale(width, height), T.ToTensor(1)]))
    items = [ds.get(i, np.random.default_rng(i)) for i in range(count)]
    return (np.stack([a for a, _ in items]), np.stack([b for _, b in items]),
            np.asarray(data["classWeights"], np.float32))


def espnet_trainer(device: str, class_weights, bf16: bool = False):
    from argparse import Namespace

    from glomeruli_segmentation_tpu_torch.train.espnet_train import (
        EspnetTrainer,
    )

    trainer = EspnetTrainer(Namespace(lr=5e-4, step_loss=100,
                                      weight_decay=5e-4, bf16=bf16),
                            device=device)
    trainer.class_weights = torch.from_numpy(class_weights).to(device)
    return trainer


def espnet_model(state_dict: dict, device: str):
    from glomeruli_segmentation_tpu_torch.train.batch_norm import (
        use_flax_batch_norm,
    )

    model = create_espnet(TRAIN_CLASSES, TRAIN_P, TRAIN_Q)
    model.load_state_dict(state_dict, strict=True)
    return use_flax_batch_norm(model).to(device)


def card_vs_cpu_step(sd: dict, batch, name_power: str,
                     device: str = "cuda") -> dict:
    """One ESPNet decoder step on the card and on the CPU from equal state
    (weights, BN statistics, Adam's state), twice: the second from the
    CPU's state after the first, copied to the card.  Float32, TF32 off
    (the trainer's own setting).  Checks and prints the loss, the largest
    gradient difference over the largest gradient, the BN running
    statistics and the parameters against ``TRAIN_PARITY``."""
    from glomeruli_segmentation_tpu_torch.train.espnet_train import nchw

    x, y, weights = batch
    runs = {}
    for name, dev in (("card", device), ("cpu", "cpu")):
        model = espnet_model(sd, dev)
        trainer = espnet_trainer(dev, weights)
        runs[name] = (model, trainer, trainer.build_optimizer(model))
    report = []
    for step in range(2):
        if step:
            cpu_model, _, cpu_opt = runs["cpu"]
            card_model, _, card_opt = runs["card"]
            card_model.load_state_dict(cpu_model.state_dict())
            card_opt.load_state_dict(copy.deepcopy(cpu_opt.state_dict()))
        losses, grads, states = {}, {}, {}
        for name, (model, trainer, optimizer) in runs.items():
            loss, _ = trainer.train_step(
                model, optimizer, nchw(torch.from_numpy(x).to(
                    trainer.device)), torch.from_numpy(y).to(trainer.device))
            losses[name] = float(loss)
            grads[name] = {k: p.grad.detach().cpu() for k, p in
                           model.named_parameters()}
            states[name] = {k: v.detach().cpu() for k, v in
                            model.state_dict().items()}
        cpu_opt = runs["cpu"][2]
        root_v = {}
        for k, p in runs["cpu"][0].named_parameters():
            st = cpu_opt.state[p]
            root_v[k] = (st["exp_avg_sq"] / (1 - 0.999 ** float(
                st["step"]))).sqrt()
        loss_rel = abs(losses["card"] - losses["cpu"]) / abs(losses["cpu"])
        g_max = max(float(g.abs().max()) for g in grads["cpu"].values())
        g_diff = max(float((grads["card"][k] - g).abs().max())
                     for k, g in grads["cpu"].items())
        stats = max(float((states["card"][k] - v).abs().max())
                    for k, v in states["cpu"].items() if "running" in k)
        well, ill, masked, total = 0.0, 0.0, 0, 0
        for k, v in root_v.items():
            d = (states["card"][k] - states["cpu"][k]).abs()
            ok = v >= 100 * 1e-8
            well = max(well, float(d[ok].max()) if ok.any() else 0.0)
            ill = max(ill, float(d[~ok].max()) if (~ok).any() else 0.0)
            masked += int((~ok).sum())
            total += ok.numel()
        print(f"train card vs CPU, ESPNet decoder f32 step {step + 1} at "
              f"{tuple(x.shape)}: loss {losses['card']:.7f} vs "
              f"{losses['cpu']:.7f} (rel {loss_rel:.3e}), largest gradient "
              f"difference {g_diff:.3e} of {g_max:.3e} ({g_diff / g_max:.3e})"
              f", BN running statistics {stats:.3e}, parameters "
              f"{well:.3e} (Adam's ill-conditioned {masked} of {total}: "
              f"{ill:.3e}) | {name_power}", flush=True)
        check(loss_rel <= TRAIN_PARITY["loss"]
              and g_diff <= TRAIN_PARITY["grad"] * g_max
              and stats <= TRAIN_PARITY["stats"]
              and well <= TRAIN_PARITY["param"] and ill <= 2 * 5e-4,
              f"card and CPU training steps disagree (step {step + 1})")
        report.append({"loss_rel": loss_rel, "grad_rel": g_diff / g_max,
                       "stats": stats, "param": well})
    return {"steps": report}


def bf16_vs_f32_steps(sd: dict, batch, name_power: str,
                      device: str = "cuda") -> dict:
    """The main scale's batch (1024x512, batch 10) through f32 and --bf16
    steps from the decoder's weights: s/step over ``TRAIN_TIMED_STEPS``
    steps after two, the first steps' losses."""
    from glomeruli_segmentation_tpu_torch.train.espnet_train import (
        nchw,
        upload,
    )

    x, y, weights = batch
    out = {}
    for bf16 in (False, True):
        model = espnet_model(sd, device)
        trainer = espnet_trainer(device, weights, bf16)
        optimizer = trainer.build_optimizer(model)
        dev = trainer.device
        times, first = [], None
        for i in range(2 + TRAIN_TIMED_STEPS):
            t0 = time.perf_counter()
            loss, hist = trainer.train_step(model, optimizer,
                                            nchw(upload(x, dev)),
                                            upload(y, dev))
            loss, _ = trainer._read(loss, hist)
            times.append(time.perf_counter() - t0)
            first = loss if first is None else first
        out["bf16" if bf16 else "f32"] = (float(np.median(times[2:])),
                                          first)
    (t32, l32), (t16, l16) = out["f32"], out["bf16"]
    rel = abs(l16 - l32) / abs(l32)
    print(f"train ESPNet decoder main scale {tuple(x.shape)}: f32 (TF32 "
          f"off) {t32:.4f} s/step, bf16 {t16:.4f} s/step ({t32 / t16:.2f}x);"
          f" first-step loss f32 {l32:.5f}, bf16 {l16:.5f} (rel {rel:.3e}, "
          f"bar {TRAIN_BF16_RTOL}) | {name_power}", flush=True)
    check(rel <= TRAIN_BF16_RTOL, f"bf16 loss {l16} vs f32 {l32}")
    return {"f32_s": t32, "bf16_s": t16, "loss_rel": rel}


def write_f32_safetensors(tensors: dict, path: Path) -> None:
    """A ``.safetensors`` file of float32 tensors: an 8-byte little-endian
    header length, the JSON header, the raw bytes."""
    header, blobs, offset = {}, [], 0
    for name, t in tensors.items():
        blob = t.detach().float().contiguous().numpy().tobytes()
        header[name] = {"dtype": "F32", "shape": list(t.shape),
                        "data_offsets": [offset, offset + len(blob)]}
        blobs.append(blob)
        offset += len(blob)
    head = json.dumps(header).encode()
    path.write_bytes(struct.pack("<Q", len(head)) + head + b"".join(blobs))


def segformer_train_run(name_power: str, device: str = "cuda") -> dict:
    """``gseg-segformer-train`` through ``cli/segformer_train.main`` on the
    card from a backbone-only mit-b0 ``model.safetensors`` of seeded
    weights, over a synthetic GTCS tree; each micro-batch step timed
    (synchronised) by wrapping the trainer's ``build_steps``.  Checks the
    adopted tensors, ``log.txt``, the checkpoints kept and the newest
    ``flax_model.pth`` through ``gseg-segformer-test``'s loader."""
    from PIL import Image

    from glomeruli_segmentation_tpu_torch.cli import (
        segformer_train as segformer_train_cli,
    )
    from glomeruli_segmentation_tpu_torch.pipeline.fused_segformer import (
        load_segformer_checkpoint,
    )
    from glomeruli_segmentation_tpu_torch.train import segformer_train

    root = WORK / "train" / "gtcs"
    specimens, crops, size = SEGFORMER_TRAIN
    data = root / GTCS_SITE / GTCS_DATE
    yy, xx = np.mgrid[:size, :size]
    for s_ in range(specimens):
        for i in range(crops):
            seed = 100 * s_ + i
            rng = np.random.RandomState(seed)
            cy, cx = (int(v) for v in rng.randint(size // 4,
                                                  3 * size // 4, 2))
            r = int(rng.randint(size // 8, size // 4))
            rgb, _ = pas_like_image(size, size, seed=seed,
                                    centers=[(cx, cy, r)])
            d2 = (yy - cy) ** 2 + (xx - cx) ** 2
            label = np.where(d2 < r * r, 1, 0).astype(np.uint8)
            label[d2 < (r * r) // 4] = 2
            label[(d2 < r * r) & (xx > cx + r // 2)] = 3 + s_ % 2
            for kind in ("rgb", "label/gtcs"):
                (data / kind / f"S{s_}").mkdir(parents=True, exist_ok=True)
            Image.fromarray(rgb).save(data / "rgb" / f"S{s_}" / f"c{i}.PNG")
            lblsave(str(data / "label/gtcs" / f"S{s_}" / f"c{i}.PNG"), label)
    ckpt = root / "mit-b0"
    ckpt.mkdir(parents=True, exist_ok=True)
    backbone = {k: t for k, t in random_segformer_state_dict(
        SEGFORMER_CONFIGS["mit-b0"], SEGFORMER_SEED).items()
        if not k.startswith("decode_head.")}
    write_f32_safetensors(backbone, ckpt / "model.safetensors")

    times = []
    build_steps = segformer_train.build_steps

    def timed_steps(*args, **kwargs):
        train_step, eval_step = build_steps(*args, **kwargs)

        def step(x, y):
            t0 = time.perf_counter()
            loss = train_step(x, y)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            return loss
        return step, eval_step

    segformer_train.build_steps = timed_steps
    torch.cuda.reset_peak_memory_stats()
    out = io.StringIO()
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(out):
            out_dir = Path(segformer_train_cli.main([
                "--site", GTCS_SITE, "--data_root", str(root),
                "--data_date", GTCS_DATE, "--model_root",
                str(root / "models"), "--output_dir", "b0", "--fold", "1",
                "--batch_size", "2", "--accumulation_steps", "2",
                "--save_interval", "1", "--max_epoch", "2",
                "--pretrained_checkpoint", str(ckpt / "model.safetensors"),
                "--device", device]))
    finally:
        segformer_train.build_steps = build_steps
    seconds = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 1e9
    adopted = re.findall(r"\((\d+) tensors adopted\)", out.getvalue())
    check(adopted == [str(len(backbone))],
          f"adopted {adopted}, want {len(backbone)}")
    log = [json.loads(line) for line in open(out_dir / "log.txt")]
    check([sorted(r) for r in log] == [["epoch", "loss"],
                                       ["epoch", "eval_mean_iou"]] * 2
          and all(math.isfinite(v) for r in log for v in r.values()),
          f"log.txt {log}")
    kept = sorted(p.name for p in out_dir.glob("checkpoint-*"))
    check(kept and "checkpoint-8" in kept, f"checkpoints kept {kept}")
    newest, labels = load_segformer_checkpoint(
        str(out_dir / "checkpoint-8" / "flax_model.pth"))
    best, _ = load_segformer_checkpoint(str(out_dir))
    check(labels == 5 and best.keys() == newest.keys()
          and config_from_state_dict(newest) == SEGFORMER_CONFIGS["mit-b0"],
          "flax_model.pth does not read back as mit-b0")
    steady = times[1:]
    print(f"train SegFormer mit-b0 512x512, batch 2, accumulation 2: "
          f"{len(times)} micro-batch steps, {float(np.mean(steady)):.4f} "
          f"s/step at steady state (first {times[0]:.3f} s), "
          f"{2 / float(np.mean(steady)):.2f} images/s; {adopted[0]} tensors "
          f"adopted; log {[round(v, 5) for r in log for k, v in r.items() if k != 'epoch']}; "
          f"kept {kept}; {seconds:.2f} s, peak memory {peak:.3f} GB | "
          f"{name_power}", flush=True)
    return {"s_per_step": float(np.mean(steady)), "kept": kept,
            "seconds": seconds}


def training_phase(name_power: str, device: str = "cuda") -> dict:
    """The training slice on the card: ``gseg-train`` (encoder, then the
    decoder from the encoder's ``model_1.pth``), the card's f32 step against
    the CPU's, bf16 against f32 at the main scale, ``gseg-segformer-train``;
    the K1, K2 and K3 counts set to 0 before and read after (the trainers
    run the plain models, as the JAX trainers reach no kernel)."""
    root = WORK / "train" / "data"
    shutil.rmtree(WORK / "train", ignore_errors=True)
    t0 = time.perf_counter()
    write_train_tree(root)
    write_s = time.perf_counter() - t0
    esp_block_fused.launches = esp_block_padded.launches = nms.launches = 0
    enc = espnet_train_run(root, "encoder", ["--scaleIn", "8"], name_power,
                           device)
    dec = espnet_train_run(root, "decoder", [
        "--scaleIn", "1", "--decoder", "True", "--pretrained",
        str(enc["savedir"] / "model_1.pth")], name_power, device)
    sd = torch.load(dec["savedir"] / "model_1.pth", weights_only=True)
    parity = card_vs_cpu_step(sd, host_batch(root, TRAIN_PARITY_BATCH,
                                             *TRAIN_MAIN_WH), name_power,
                              device)
    bf16 = bf16_vs_f32_steps(sd, host_batch(root, TRAIN_BF16_BATCH,
                                            *TRAIN_MAIN_WH), name_power,
                             device)
    segformer = segformer_train_run(name_power, device)
    launches = (esp_block_fused.launches, esp_block_padded.launches,
                nms.launches)
    print(f"train phase kernel launches (K1, K2, K3): {launches} (the "
          f"trainers run the plain models); data written in {write_s:.2f} s"
          f" | {name_power}", flush=True)
    return {"launches": launches, "encoder": enc, "decoder": dec,
            "parity": parity, "bf16": bf16, "segformer": segformer}


def detector_train_run(root: Path, name: str, extra: list, steps: int,
                       name_power: str, device: str = "cuda") -> dict:
    """``gseg-train-detector`` through ``cli/train_detector.main`` on the
    card for ``steps`` steps, each step's sampler and step seconds recorded
    (the step ended by reading its losses back), the K3 count set to 0
    just before and read just after, the peak memory.  Checks the
    checkpoint, every loss finite and K3 launched once a step; prints
    s/step at steady state (the first ``DET_TRAIN_WARM`` steps left out),
    the sampler's share and the peak memory."""
    from glomeruli_segmentation_tpu_torch.cli import (
        train_detector as train_detector_cli,
    )
    from glomeruli_segmentation_tpu_torch.train import (
        detector_driver,
        od_api_finetune,
    )

    rows, losses = [], []
    sample = detector_driver.SlideWindowSampler.sample_batch
    step = detector_driver.train_step

    def timed_sample(self, rng):
        t0 = time.perf_counter()
        out = sample(self, rng)
        rows.append([time.perf_counter() - t0])
        return out

    def timed_step(*args, **kw):
        t0 = time.perf_counter()
        out = step(*args, **kw)
        losses.append(torch.stack(list(out[0].values())).cpu().tolist())
        rows[-1].append(time.perf_counter() - t0)
        return out

    out_dir = WORK / "det_train" / name.replace(" ", "_")
    detector_driver.SlideWindowSampler.sample_batch = timed_sample
    detector_driver.train_step = timed_step
    nms.launches = 0
    if device == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    try:
        path = Path(train_detector_cli.main([
            "--data_dir", str(root / "data"), "--target_list",
            str(root / "targets.txt"), "--output_dir", str(out_dir),
            "--steps", str(steps), "--batch_size", str(DET_TRAIN_BATCH),
            "--image_size", str(DET_TRAIN_SIZE), "--lr", str(DET_TRAIN_LR),
            "--backbone", DET_TRAIN_BACKBONE, "--device", device, *extra]))
    finally:
        detector_driver.SlideWindowSampler.sample_batch = sample
        detector_driver.train_step = step
    seconds = time.perf_counter() - t0
    launches = nms.launches
    peak_gb = (torch.cuda.max_memory_allocated() / 1e9 if device == "cuda"
               else float("nan"))
    expect = (od_api_finetune.OD_API_CKPT_NAME if "--finetune_pb" in extra
              else "detector.ckpt.pth")
    check(path == out_dir / expect and path.is_file(),
          f"detector training {name}: wrote {path}")
    check(launches == (steps if device == "cuda" else 0),
          f"detector training {name}: K3 launched {launches} times in "
          f"{steps} steps")
    check(len(losses) == steps and all(math.isfinite(v) for row in losses
                                       for v in row),
          f"detector training {name}: a loss is not finite: {losses[-1:]}")
    # the JAX driver draws one batch for model.init before its loop
    timed = [r for r in rows if len(r) == 2][DET_TRAIN_WARM:]
    sample_s = sum(r[0] for r in timed)
    step_s = sum(r[1] for r in timed)
    r = {"path": path, "steps": steps, "launches": launches,
         "seconds": seconds, "peak_gb": peak_gb,
         "s_per_step": (sample_s + step_s) / len(timed),
         "step_s": step_s / len(timed),
         "sampler_share": sample_s / (sample_s + step_s),
         "first_losses": losses[0], "last_losses": losses[-1]}
    print(f"detector training {name} ({DET_TRAIN_SIZE}x{DET_TRAIN_SIZE}, "
          f"batch {DET_TRAIN_BATCH}): {r['s_per_step']:.4f} s/step at "
          f"steady state over {len(timed)} steps (the step "
          f"{r['step_s']:.4f} s, the window sampler "
          f"{r['sampler_share']:.3f} of each), peak memory {peak_gb:.3f} GB,"
          f" K3 launches {launches} in {steps} steps; total loss "
          f"{losses[0][-1]:.4f} at step 0, {losses[-1][-1]:.4f} at step "
          f"{steps - 1}; run {seconds:.2f} s, {path.name} written | "
          f"{name_power}", flush=True)
    return r


def detector_sampler_batch(root: Path, batch: int, seed: int):
    """A training batch of the staged tree's windows, on the host."""
    from glomeruli_segmentation_tpu_torch.train.detector_driver import (
        DetectorTrainConfig,
        SlideWindowSampler,
    )

    sampler = SlideWindowSampler(
        "OPT_PAS", str(root / "data"), str(root / "targets.txt"),
        DetectorTrainConfig(image_size=DET_TRAIN_SIZE, batch_size=batch))
    return sampler.sample_batch(np.random.default_rng(seed))


def native_train_model(state: dict, device: str, kernel_nms: bool = True):
    from glomeruli_segmentation_tpu_torch.models.faster_rcnn import (
        FasterRCNN,
    )

    cfg = FasterRCNNConfig(image_size=(DET_TRAIN_SIZE, DET_TRAIN_SIZE),
                           backbone=DET_TRAIN_BACKBONE)
    return FasterRCNN(cfg, kernel_nms=kernel_nms, train_form=True
                      ).load_state(state).to(device)


def native_step(model, batch, device: str):
    """One f32 training step of ``model`` on a host batch from a fresh
    Adam: (losses, proposals, gradients, Adam's sqrt of the corrected v,
    the detector state after), on the CPU, the last three keyed as the
    detector state."""
    from glomeruli_segmentation_tpu_torch.models.resnet import (
        detector_state,
    )
    from glomeruli_segmentation_tpu_torch.train import detector_driver

    optimizer = torch.optim.Adam(model.parameters(), lr=DET_TRAIN_LR,
                                 eps=1e-8)
    anchors = build_anchors(model.config).to(device)
    losses, proposals = detector_driver.train_step(
        model, optimizer, detector_driver.native_forward, anchors,
        detector_driver.upload_batch(batch, torch.device(device)))
    grads = detector_state({k: p.grad for k, p in model.named_parameters()})
    root_v = detector_state({
        k: (optimizer.state[p]["exp_avg_sq"] / (1 - 0.999)).sqrt()
        for k, p in model.named_parameters()})
    return ({k: float(v) for k, v in losses.items()}, proposals.cpu(), grads,
            root_v, model.detector_state())


def with_proposals(model, proposals: torch.Tensor):
    """``model``, its proposal stage replaced by fixed proposals."""
    model.propose = lambda *a: (proposals, torch.zeros(
        proposals.shape[:2], device=proposals.device))
    return model


def step_distance(got, want) -> dict:
    """How far one ``native_step`` lies from another: the largest relative
    loss difference, the largest gradient difference over the largest
    gradient, the largest BN running-statistic difference, and the
    largest parameter difference where Adam's update is well conditioned
    (``DET_ILL_CONDITIONED``) and where it is not."""
    losses, _, grads, _, after = got
    want_l, _, want_g, root_v, want_after = want
    g_max = max(float(g.abs().max()) for g in want_g.values())
    out = {"loss": max(abs(losses[k] - w) / abs(w)
                       for k, w in want_l.items() if w),
           "grad": max(float((grads[k] - g).abs().max())
                       for k, g in want_g.items()) / g_max,
           "stats": max(float((after[k] - v).abs().max()) for k, v in
                        want_after.items()
                        if k.endswith((".bn.mean", ".bn.var"))),
           "param": 0.0, "param_ill": 0.0}
    for k, v in root_v.items():
        d = (after[k] - want_after[k]).abs()
        ok = (v >= DET_ILL_CONDITIONED) | (v == 0)
        if ok.any():
            out["param"] = max(out["param"], float(d[ok].max()))
        if (~ok).any():
            out["param_ill"] = max(out["param_ill"], float(d[~ok].max()))
    return out


def detector_card_vs_cpu(state: dict, root: Path, name_power: str,
                         device: str = "cuda") -> dict:
    """One f32 step of the ResNet-50-C4 trainer (512x512, batch 1) on the
    card and on the CPU from equal state.  The proposals first: the share
    of rows equal on both devices; where they differ, the card's step runs
    again on the CPU's proposals.  Then the CPU's float32 noise floor: the
    same step on the CPU with half its threads, on the same proposals
    (only the summation order changes).  The card's losses, gradients and
    BN statistics must lie within ``TRAIN_PARITY`` of the CPU's, or within
    ``DET_NOISE_FACTOR`` times the floor where the floor itself is above
    the bar; the parameters are printed (Adam's first update turns a
    gradient near its rounding error into up to 2 lr either way)."""
    batch = detector_sampler_batch(root, DET_TRAIN_PARITY_BATCH, 11)
    t0 = time.perf_counter()
    cpu = native_step(native_train_model(state, "cpu"), batch, "cpu")
    cpu_s = time.perf_counter() - t0
    threads = torch.get_num_threads()
    torch.set_num_threads(max(1, threads // 2))
    try:
        floor = step_distance(native_step(with_proposals(
            native_train_model(state, "cpu"), cpu[1]), batch, "cpu"), cpu)
    finally:
        torch.set_num_threads(threads)
    card = native_step(native_train_model(state, device), batch, device)
    equal_rows = float((card[1] == cpu[1]).all(-1).float().mean())
    on_cpu_proposals = equal_rows < 1.0
    if on_cpu_proposals:
        card = native_step(with_proposals(native_train_model(state, device),
                                          cpu[1].to(device)), batch, device)
    d = step_distance(card, cpu)
    bars = {k: max(TRAIN_PARITY[k], DET_NOISE_FACTOR * floor[k])
            for k in ("loss", "grad", "stats")}
    print(f"detector training card vs CPU, ResNet-50-C4 f32 step at "
          f"{DET_TRAIN_SIZE}x{DET_TRAIN_SIZE}, batch "
          f"{DET_TRAIN_PARITY_BATCH}: proposals equal on {equal_rows:.4f} "
          f"of rows" + (" (compared on the CPU's proposals)"
                        if on_cpu_proposals else "")
          + f"; total loss {card[0]['total']:.7f} vs {cpu[0]['total']:.7f}; "
          + "; ".join(f"{k} {d[k]:.3e} (CPU at {threads // 2} threads "
                      f"against {threads}: {floor[k]:.3e}; bar "
                      f"{bars[k]:.3e})" for k in bars)
          + f"; parameters {d['param']:.3e} where Adam is well conditioned,"
          f" {d['param_ill']:.3e} elsewhere (the floor {floor['param']:.3e},"
          f" {floor['param_ill']:.3e}); CPU step {cpu_s:.2f} s | "
          f"{name_power}", flush=True)
    check(all(d[k] <= bars[k] for k in bars)
          and max(d["param"], d["param_ill"]) <= 2 * DET_TRAIN_LR,
          "detector training: card and CPU steps disagree")
    return {"equal_proposals": equal_rows,
            "on_cpu_proposals": on_cpu_proposals, "distance": d,
            "floor": floor}


def detector_training_phase(name_power: str, consts: dict = None,
                            device: str = "cuda") -> dict:
    """The detector training slice on the card, on the staged GT slide's
    tree (written here unless the staged segment phase left it):
    ``gseg-train-detector`` for the native ResNet-50-C4 in f32 and in
    ``--bf16``, and ``--finetune_pb`` on ``consts`` (the e2e detector's
    random OD-API constants) written as a frozen graph, each with K3
    launched once a step; K3 against ``nms_plain`` on the real RPN
    problems of a training batch at both training shapes; one f32 step
    with and without K3 from equal state; the card's f32 step against the
    CPU's; each checkpoint through ``cli/detect.load_backend`` detecting a
    window batch on the card."""
    root = WORK / "staged_segment"
    shutil.rmtree(WORK / "det_train", ignore_errors=True)
    t0 = time.perf_counter()
    if not (root / "targets.txt").is_file():
        staged_segment_tree(root)
    if consts is None:
        consts = random_od_api_consts(E2E_DETECTOR_SEED, device=device)
    graph = WORK / "det_train" / "frozen_inference_graph.pb"
    graph.parent.mkdir(parents=True)
    load_graph_writer().write_graph(consts, str(graph))
    setup_s = time.perf_counter() - t0
    runs = {
        "native f32": detector_train_run(
            root, "native f32", [], DET_TRAIN_STEPS["native f32"],
            name_power, device),
        "native bf16": detector_train_run(
            root, "native bf16", ["--bf16"], DET_TRAIN_STEPS["native bf16"],
            name_power, device),
        "od_api f32": detector_train_run(
            root, "od_api f32", ["--finetune_pb", str(graph)],
            DET_TRAIN_STEPS["od_api f32"], name_power, device),
    }
    first = (runs["native f32"]["first_losses"][-1],
             runs["native bf16"]["first_losses"][-1])
    bf16_rel = abs(first[1] - first[0]) / abs(first[0])
    speedup = (runs["native f32"]["s_per_step"]
               / runs["native bf16"]["s_per_step"])
    print(f"detector training native bf16 against f32: {speedup:.2f}x the "
          f"speed; step-0 total loss {first[1]:.5f} vs {first[0]:.5f} "
          f"(rel {bf16_rel:.3e}, bar {TRAIN_BF16_RTOL}) | {name_power}",
          flush=True)
    check(bf16_rel <= TRAIN_BF16_RTOL, "detector training: bf16 loss")

    from glomeruli_segmentation_tpu_torch.convert.detector_import import (
        load_detector_checkpoint,
    )
    from glomeruli_segmentation_tpu_torch.convert.pb_import import (
        load_od_api_checkpoint,
    )
    from glomeruli_segmentation_tpu_torch.models.od_api_frcnn import (
        ODAPIConfig,
        ODAPIFasterRCNN,
    )
    from glomeruli_segmentation_tpu_torch.models.od_api_frcnn import (
        build_anchors as od_anchors,
    )
    from glomeruli_segmentation_tpu_torch.train.detector_driver import (
        upload_batch,
    )

    # ---- K3 on the real RPN problems of one training batch ----
    batch = detector_sampler_batch(root, DET_TRAIN_BATCH, 7)
    x = upload_batch(batch, torch.device(device))[0]
    state, _ = load_detector_checkpoint(str(runs["native f32"]["path"]))
    params, n_cls, saved = load_od_api_checkpoint(
        str(runs["od_api f32"]["path"]))
    od_cfg = ODAPIConfig(**{k: tuple(v) if isinstance(v, list) else v
                            for k, v in saved.items()})
    od_model = ODAPIFasterRCNN(params, od_cfg, "float32").to(device).train()
    native = native_train_model(state, device).train()
    with torch.no_grad(), tf32(False, False):
        anchors = build_anchors(native.config).to(device)
        obj, deltas = native.rpn_outputs(native.features(x))
        problems = {"native": native.rpn_candidates(obj, deltas, anchors)}
        od_anchor_t = od_anchors(od_cfg).to(device)
        _, obj, deltas = od_model.first_stage(x)
        problems["od_api"] = od_model.rpn_candidates(obj, deltas,
                                                     od_anchor_t)
    k3 = {}
    for name, (boxes, scores) in problems.items():
        p_, n_, k_, thr = K3_TRAIN_SHAPES[name]
        check(tuple(scores.shape) == (p_, n_), f"{name} training NMS "
              f"problem {tuple(scores.shape)}")
        label = f"{name} training rpn"
        k3[label] = nms_case(boxes.contiguous(), scores.contiguous(), k_, thr)
        print_nms_case(label, k3[label], name_power)
    del native, od_model, problems, obj, deltas

    # ---- one f32 step with and without K3, from equal state ----
    steps = {}
    for kernel_nms in (True, False):
        nms.launches = 0
        steps[kernel_nms] = native_step(
            native_train_model(state, device, kernel_nms), batch, device)
        check(nms.launches == int(kernel_nms and device == "cuda"),
              f"K3 launched "
              f"{nms.launches} times in a kernel_nms={kernel_nms} step")
    same_props = torch.equal(steps[True][1], steps[False][1])
    nms_rel = max(abs(steps[True][0][k] - v) / abs(v)
                  for k, v in steps[False][0].items() if v)
    print(f"detector training f32 step with and without K3 from equal "
          f"state: proposals bitwise equal {same_props}, largest loss rel "
          f"difference {nms_rel:.3e} | {name_power}", flush=True)
    check(same_props and nms_rel <= 1e-6,
          "detector training: K3 and plain NMS steps differ")
    del steps

    parity = detector_card_vs_cpu(state, root, name_power, device)

    # ---- each checkpoint through gseg-detect's loader, on the card ----
    images = batch[0]
    detected = {}
    for name, overrides in (("native f32", None), ("od_api f32", {})):
        backend = detect_cli.load_backend(str(runs[name]["path"].parent),
                                          None, DET_TRAIN_BATCH,
                                          od_api_overrides=overrides,
                                          device=device)
        nms.launches = 0
        boxes, scores, classes, num = backend.detect_batch(images)
        check(nms.launches == 2 * (device == "cuda"),
              f"{name} checkpoint: K3 launched "
              f"{nms.launches} times in one batch")
        check(boxes.shape[0] == DET_TRAIN_BATCH and np.isfinite(
            scores).all() and np.isfinite(boxes).all(),
            f"{name} checkpoint: detections {boxes.shape}")
        detected[name] = (type(backend).__name__, int(num.sum()))
    print(f"detector training checkpoints detect a batch of "
          f"{DET_TRAIN_BATCH} windows on the card (K3 launched 2 times "
          f"each): " + ", ".join(f"{k} -> {b} {n} detections" for k, (b, n)
                                  in detected.items())
          + f"; tree and graph ready in {setup_s:.2f} s | {name_power}",
          flush=True)
    return {"runs": runs, "k3": k3, "parity": parity,
            "launches": {k: r["launches"] for k, r in runs.items()},
            "nms_rel": nms_rel}


def main(argv=None) -> int:
    import argparse

    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--only", choices=["detector_training"],
                        help="build, then run this phase alone and print "
                             "its lines, without the result lines")
    only = parser.parse_args(argv).only
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    name_power = card()
    print(name_power)
    phase_s, t_phase = {}, time.perf_counter()

    def phase_done(name):
        nonlocal t_phase
        now = time.perf_counter()
        phase_s[name] = now - t_phase
        t_phase = now
    kind = torch.cuda.get_device_name(0)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {kind} count {torch.cuda.device_count()}; "
          f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32} "
          f"cuda.matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32}",
          flush=True)

    # ---- build ----
    t0 = time.perf_counter()
    _build.build_all()
    print(f"build: {time.perf_counter() - t0:.2f} s for {_build.SOURCES}")
    for src, (seconds, log) in _build.build_log.items():
        print(f"  nvcc {src}.cu {seconds:.2f} s: " + " | ".join(
            ptxas_summary(log)))
    check_sass("K1", "esp_block", 4, name_power)
    check_sass("K2", "esp_block_dma", 2, name_power)
    # the native slide reader, with which every phase below opens slides
    t0 = time.perf_counter()
    reader_so = reader_build.build()
    print(f"native slide reader: {reader_so.relative_to(ROOT)} "
          f"({time.perf_counter() - t0:.2f} s, g++ "
          + (f"{reader_build.build_log[0]:.2f} s" if reader_build.build_log
             else "not needed") + ") linking "
          + ", ".join(reader_build.libraries()), flush=True)

    phase_done("build")
    if only == "detector_training":
        detector_training_phase(name_power)
        phase_done("detector training")
        print("chip_smoke phases (s): " + ", ".join(
            f"{k} {v:.1f}" for k, v in phase_s.items()) + f" | {name_power}",
            flush=True)
        return 0

    # ---- kernels K1 and K2 against their plain versions ----
    classes, p, q = 5, 2, 8
    sd = random_state_dict(1, classes, p, q)
    ckpts = write_checkpoints(WORK / "folds", classes, p, q)
    tf32 = (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False  # the plain version in full f32
    torch.backends.cuda.matmul.allow_tf32 = False
    k1_ops = [torch.from_numpy(v) for v in
              pack_esp_weights(sd, "encoder.level3.0.")]
    k1_ops64 = [torch.from_numpy(v) for v in
                pack_esp_weights(sd, "encoder.level2.0.")]
    # K2's operands: the first block of the packed level 2 of the 5 folds,
    # per fold as the model packs them, and dense from the folds' own packs
    # for the plain version
    fold_sds = [load_espnet_state_dict(c) for c in ckpts]
    packed_f32 = PackedEnsembleESPNet(
        fold_sds, [FOLD_NORMALIZATION[f][0] for f in range(1, 6)],
        [FOLD_NORMALIZATION[f][1] for f in range(1, 6)],
        fuse_level2=True, dtype=torch.float32)
    k2_ops = [t.cpu() for t in packed_f32.level2_kernel[0]]
    k2_dense = [torch.from_numpy(a) for a in _esp_fused_operands(
        PackedEnsembleESPNet._host_pack(
            [FusedESPNet(s_, dtype=torch.float32, device="cpu")
             .enc["level2"][0] for s_ in fold_sds],
            packed_f32.perm320, packed_f32.perm320))]
    k2_channels = k2_dense[0].shape[0]
    del packed_f32, fold_sds
    k1, k2 = {}, {}
    for dtype in (torch.float32, torch.bfloat16):
        gen = torch.Generator(device="cuda").manual_seed(0)
        x = torch.randn(K1_SHAPE, generator=gen, device="cuda").to(dtype)
        k1[dtype] = block_case("K1", esp_block_fused, esp_block_plain, x,
                               k1_ops, math.prod(K1_SHAPE[:3]))
        print_block_case("K1 esp_block_fused", k1[dtype], name_power)
        for shape in K1_EDGE_SHAPES:
            for add_residual in (True, False):
                edge = block_case(
                    f"K1 {shape} residual={add_residual}",
                    lambda *a: esp_block_fused(*a, add_residual=add_residual),
                    lambda *a: esp_block_plain(*a, add_residual=add_residual),
                    torch.randn(shape, generator=gen, device="cuda").to(dtype),
                    k1_ops if shape[3] == 128 else k1_ops64, 0, timed=False)
                print(f"K1 edge {edge['dtype']} {shape} residual="
                      f"{add_residual}: max abs err {edge['max_abs_err']:.3e}"
                      f" max rel err {edge['max_rel_err']:.3e} (tolerance "
                      f"atol {edge['tolerance'][0]} rtol "
                      f"{edge['tolerance'][1]})", flush=True)
        x = esp_pad_io(torch.randn(K2_SHAPE, generator=gen, device="cuda")
                       .to(dtype))
        check(tuple(x.shape) == K2_PADDED, f"K2 input {tuple(x.shape)}")
        k2[dtype] = block_case(
            "K2", esp_block_padded, esp_block_padded_plain, x, k2_ops,
            math.prod(K2_SHAPE[:3]),
            after=lambda y: check_zero_padding(y, k2_channels),
            plain_operands=k2_dense, groups=K2_FOLDS,
            split=r"(esp_dma_\w+?)_kernel")
        print_block_case("K2 esp_block_padded", k2[dtype], name_power)
        del x
        for b_, h_, w_, folds in K2_EDGE_SHAPES:
            ops, dense = first_folds(k2_ops, folds)
            for add_residual in (True, False):
                edge = block_case(
                    f"K2 {(b_, h_, w_, folds)} residual={add_residual}",
                    lambda *a: esp_block_padded(*a,
                                                add_residual=add_residual),
                    lambda *a: esp_block_padded_plain(
                        *a, add_residual=add_residual),
                    esp_pad_io(torch.randn((b_, h_, w_, 64 * folds),
                                           generator=gen, device="cuda")
                               .to(dtype)),
                    ops, 0, timed=False, plain_operands=dense,
                    after=lambda y, c=64 * folds: check_zero_padding(y, c))
                print(f"K2 edge {edge['dtype']} {tuple(edge['shape'])} "
                      f"{folds} folds residual={add_residual}: max abs err "
                      f"{edge['max_abs_err']:.3e} max rel err "
                      f"{edge['max_rel_err']:.3e} (tolerance atol "
                      f"{edge['tolerance'][0]} rtol {edge['tolerance'][1]});"
                      f" halo columns and pad channels zero", flush=True)
    (torch.backends.cudnn.allow_tf32,
     torch.backends.cuda.matmul.allow_tf32) = tf32

    phase_done("K1 and K2")

    # ---- the main path: 5-fold slide segmentation at full width ----
    slide, boxes = synthetic_slide(seed=0, height=6144, width=8192,
                                   n_boxes=80, box_min=256, box_max=1200)
    batch = 32
    n_batches = math.ceil(len(boxes) / batch)
    config = EnsembleConfig(checkpoints=ckpts, classes=classes, p=p, q=q,
                            batch_size=batch)
    ensemble = EnsembleSegmenter(config, engine="fused")
    check(ensemble.fuse_level3, "batch 32 must take the kernel path")
    segment(ensemble, slide, boxes[:batch])  # warm-up, not counted
    torch.cuda.reset_peak_memory_stats()
    canvas, seconds, (launches, _) = segment(ensemble, slide, boxes)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    want = q * 5 * n_batches
    check(launches == want, f"K1 launched {launches} times, want {want}")
    check_canvas(canvas, slide, boxes, classes, "fused bf16")
    print(f"slice bf16 batch {batch}: {len(boxes)} crops in {n_batches} "
          f"batches, {seconds:.4f} s/slide, {len(boxes) / seconds:.2f} "
          f"crops/s, K1 launches {launches}, peak memory {peak_gb:.3f} GB, "
          f"classes present {np.unique(canvas).tolist()} | {name_power}",
          flush=True)

    # the same slide with level 3 on plain torch ops, in turns with the
    # kernel path: plain, kernel, kernel, plain
    plain_l3 = EnsembleSegmenter(config, fuse_level3=False)
    segment(plain_l3, slide, boxes[:batch])  # warm-up
    turns = {"kernel": [seconds], "plain": []}
    same = {"kernel": [], "plain": []}
    for name in ("plain", "kernel"):
        ens = ensemble if name == "kernel" else plain_l3
        out, secs, _ = segment(ens, slide, boxes)
        turns[name].append(secs)
        same[name].append(float((out == canvas).mean()))
    print("slice bf16 s/slide in turns: kernel path "
          + ", ".join(f"{s:.4f}" for s in turns["kernel"])
          + f" (median {np.median(turns['kernel']):.4f}); plain level 3 "
          + ", ".join(f"{s:.4f}" for s in turns["plain"])
          + f" (median {np.median(turns['plain']):.4f}); canvas pixels equal "
          f"to the first kernel run: kernel {min(same['kernel']):.6f}, plain "
          f"{min(same['plain']):.6f} | {name_power}", flush=True)
    del plain_l3
    print_trace("bf16 slide", trace(
        lambda: FusedSlideSegmenter(ensemble).segment_slide(slide, boxes)),
        name_power)
    k2_launches, k2_composed_ms = packed_phase(config, ensemble, slide,
                                               boxes, canvas, name_power)
    del ensemble

    # ---- f32 "highest": kernel paths against their plain versions ----
    f32 = EnsembleConfig(checkpoints=ckpts, classes=classes, p=p, q=q,
                         batch_size=batch, compute_dtype="float32",
                         precision="highest")
    with_kernel, t_k, (n_k, _) = segment(EnsembleSegmenter(f32), slide,
                                         boxes)
    plain, t_p, (n_p, _) = segment(EnsembleSegmenter(f32, fuse_level3=False),
                                   slide, boxes)
    check(n_k == want and n_p == 0, f"f32 launches {n_k}/{n_p}")
    same_kp = float((with_kernel == plain).mean())
    same_bf = float((with_kernel == canvas).mean())
    print(f"slice f32 highest: kernel path {t_k:.4f} s/slide "
          f"({len(boxes) / t_k:.2f} crops/s), plain level 3 {t_p:.4f} s "
          f"({len(boxes) / t_p:.2f} crops/s); equal canvas pixels kernel vs "
          f"plain {same_kp:.6f}, bf16 vs f32 {same_bf:.6f} of "
          f"{canvas.size} | {name_power}", flush=True)
    check(same_kp >= 0.999, f"f32 kernel/plain canvases agree on {same_kp}")
    packed_f32_phase(f32, slide, boxes, with_kernel, name_power)

    # ---- fused model against the plain nn.Module on a small input ----
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    net = create_espnet(classes, p, q).cuda().eval()
    net.load_state_dict(sd, strict=True)
    x = torch.randn(2, 3, 128, 256, generator=torch.Generator()
                    .manual_seed(3)).cuda() / 255
    with torch.no_grad():
        want_logits = net(x)
    got_logits = FusedESPNet(sd)(x)
    diff = (got_logits - want_logits).abs().max().item()
    same = (got_logits.argmax(1) == want_logits.argmax(1)).float().mean()
    print(f"FusedESPNet (K1) vs plain ESPNet, f32, (2, 3, 128, 256): max abs "
          f"logit diff {diff:.3e}, argmax agreement {same.item():.6f}")
    check(diff < 1e-3 and same.item() >= 0.999, "fused model disagrees")
    (torch.backends.cudnn.allow_tf32,
     torch.backends.cuda.matmul.allow_tf32) = tf32

    phase_done("segmenter")
    k3, det_launches = detector_phases(name_power)
    phase_done("ResNet detector")
    od_k3, od_launches = od_api_phases(name_power)
    phase_done("OD-API detector")
    e2e = e2e_phase(WORK / "folds", name_power)
    phase_done("e2e")
    model_dir = write_model_dir(e2e["params"], WORK / "model")
    staged_detect_phase(e2e, model_dir, name_power)
    phase_done("staged detect")
    staged = staged_segment_phase(WORK / "folds", name_power)
    phase_done("staged segment")
    warmup_phase(WORK / "folds", model_dir, name_power)
    phase_done("warm-up")
    served = serve_phase(e2e, WORK / "folds", model_dir, name_power)
    phase_done("serve")
    segformer = segformer_model_phase(name_power)
    phase_done("SegFormer model")
    segformer_e2e = segformer_e2e_phase(e2e, model_dir, segformer["b0_dir"],
                                        name_power)
    phase_done("SegFormer e2e")
    staged_gtcs_phase(segformer["b4_sd"], name_power)
    phase_done("staged GTCS")
    reader_phase(reader_crops(e2e, staged), name_power)
    phase_done("reader")
    selftest = selftest_phase(e2e["slide"], e2e["consts"], e2e["params"],
                              name_power)
    phase_done("selftest")
    training = training_phase(name_power)
    phase_done("training")
    det_training = detector_training_phase(name_power, e2e["consts"])
    phase_done("detector training")
    check(wsi.python_fallbacks == 0 and native_reader.unavailable_reason
          is None, f"{wsi.python_fallbacks} slides opened with the Python "
          f"reader: {native_reader.unavailable_reason}")
    print("chip_smoke phases (s): " + ", ".join(
        f"{k} {v:.1f}" for k, v in phase_s.items())
        + f"; total {sum(phase_s.values()):.1f} | {name_power}", flush=True)

    def esp_entry(name, source, replaces, r, n_launch, **extra):
        bf16, f32r = r[torch.bfloat16], r[torch.float32]
        return {
            "name": name, "route": "cuda",
            "source": f"glomeruli_segmentation_tpu_torch/csrc/{source}",
            "replaces": f"glomeruli_segmentation_tpu/ops/pallas/{replaces}",
            "launches": n_launch, "max_abs_err": bf16["max_abs_err"],
            "ms": bf16["ms"], "plain_ms": bf16["plain_ms"],
            "bound_ms": bf16["bound_ms"], "bound_by": bf16["bound_by"],
            "library_ms": None, "dtype": "bfloat16", "shape": bf16["shape"],
            "gflop": bf16["gflop"], "gflop_dense": bf16["gflop_dense"],
            "dense_bound_ms": bf16["dense_bound_ms"], **extra,
            "f32": {k: f32r[k] for k in ("max_abs_err", "ms", "plain_ms",
                                         "bound_ms", "bound_by",
                                         "dense_bound_ms")}}

    def nms_entry(path, cases, main_case, n_launch):
        r = cases[main_case]
        return {
            "name": "nms", "route": "cuda",
            "source": "glomeruli_segmentation_tpu_torch/csrc/nms.cu",
            "replaces": "glomeruli_segmentation_tpu/ops/pallas/"
                        "nms_pallas.py:27 (_nms_kernel)",
            "path": path, "launches": n_launch,
            "max_abs_err": max(c["max_abs_err"] for c in cases.values()),
            "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": None, "dtype": "float32", "shape": r["shape"],
            "device_ms": r["device_ms"], "split_ms": r["split_ms"],
            "cases": {label: {k: c[k] for k in (
                "shape", "ms", "device_ms", "split_ms", "plain_ms",
                "bound_ms", "bound_by")} for label, c in cases.items()}}

    print(json.dumps({"kernels": [
        esp_entry("esp_block_fused", "esp_block.cu",
                  "esp_block.py:72 (_esp_kernel)", k1, launches,
                  e2e_launches=e2e["launches"][0],
                  serve_launches=served["launches"][0],
                  segformer_e2e_launches=segformer_e2e["launches"][0],
                  staged_segment_launches=staged["launches"],
                  training_launches=training["launches"][0],
                  staged_segment_f32={k: staged["k1"][k] for k in (
                      "shape", "max_abs_err", "ms", "plain_ms", "bound_ms",
                      "bound_by")}),
        esp_entry("esp_block_padded", "esp_block_dma.cu",
                  "esp_block.py:167 (_esp_kernel_dma)", k2, k2_launches,
                  composed_ms=k2_composed_ms,
                  training_launches=training["launches"][1],
                  e2e_launches=e2e["launches"][1],
                  serve_launches=served["launches"][1],
                  segformer_e2e_launches=segformer_e2e["launches"][1]),
        dict(nms_entry("ResNet-50-C4 detector",
                       {**k3, "native training rpn":
                        det_training["k3"]["native training rpn"]},
                       "rpn seeded", det_launches),
             training_launches=training["launches"][2],
             detector_training_launches=(
                 det_training["launches"]["native f32"]
                 + det_training["launches"]["native bf16"])),
        dict(nms_entry("OD-API frozen-graph detector",
                       {**od_k3, **selftest["k3"], "od_api training rpn":
                        det_training["k3"]["od_api training rpn"]},
                       "od_api rpn proposals", od_launches),
             e2e_launches=e2e["launches"][2],
             serve_launches=served["launches"][2],
             segformer_e2e_launches=segformer_e2e["launches"][2],
             selftest_launches=selftest["launches"],
             training_launches=training["launches"][2],
             detector_training_launches=det_training["launches"][
                 "od_api f32"]),
    ]}))
    print(name_power)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
