"""GTCS glomerular dataset for the SegFormer variant.

The port's own copy of ``glomeruli_segmentation_tpu/data/
segformer_dataset.py`` (numpy, cv2 and PIL; a test holds the two equal).

Native equivalent of ``SegFormer.common.ResizedGlomerularDataset`` (absent
from the reference tree; behaviour reconstructed from call sites at
``module/SegFormer/train/train.py:179-186`` and
``module/SegFormer/test/test.py:218-224``):

- directory layout ``root_dir/{rgb,label/gtcs}/<specimen>/<crop>.PNG``;
- fold-aware patient-level split: with fold k of 5, validation patients are
  ``sorted(patients)[k-1::5]``; mode 'test' uses every sample;
- images are resized to 512x512 and ImageNet-normalized (the
  SegformerFeatureExtractor contract, ``reduce_labels=False``); train-mode
  labels are resized alongside, test-mode labels keep their native size;
- ``detected_mode`` switches the rgb subdir to detector-produced crops.
"""
from __future__ import annotations

import glob
import os
from typing import List, Optional, Tuple

import cv2
import numpy as np
from PIL import Image

IMAGENET_MEAN = np.asarray([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.asarray([0.229, 0.224, 0.225], np.float32)
INPUT_SIZE = 512


def feature_extract(image_rgb: np.ndarray, size: int = INPUT_SIZE) -> np.ndarray:
    """SegformerFeatureExtractor: resize 512x512, /255, ImageNet norm (NHWC)."""
    img = cv2.resize(image_rgb, (size, size), interpolation=cv2.INTER_LINEAR)
    img = img.astype(np.float32) / 255.0
    return (img - IMAGENET_MEAN) / IMAGENET_STD


class ResizedGlomerularDataset:
    def __init__(self, root_dir: str, rgb_subdir: str = "rgb",
                 label_subdir: str = "label/gtcs", transforms=None,
                 mode: str = "train", fold: int = 1,
                 detected_mode: int = 0, input_size: int = INPUT_SIZE):
        self.root_dir = root_dir
        self.transforms = transforms
        self.mode = mode
        self.fold = fold
        self.input_size = input_size
        rgb_dir = os.path.join(root_dir,
                               "detected" if detected_mode else rgb_subdir)
        label_dir = os.path.join(root_dir, label_subdir)
        pairs: List[Tuple[str, str]] = []
        for rgb_path in sorted(glob.glob(os.path.join(rgb_dir, "*", "*.PNG"))):
            specimen = os.path.basename(os.path.dirname(rgb_path))
            label_path = os.path.join(label_dir, specimen,
                                      os.path.basename(rgb_path))
            if os.path.isfile(label_path):
                pairs.append((rgb_path, label_path))
        patients = sorted({os.path.basename(os.path.dirname(p))
                           for p, _ in pairs})
        val_patients = set(patients[fold - 1::5])
        if mode == "train":
            pairs = [p for p in pairs
                     if os.path.basename(os.path.dirname(p[0]))
                     not in val_patients]
        elif mode == "val":
            pairs = [p for p in pairs
                     if os.path.basename(os.path.dirname(p[0]))
                     in val_patients]
        self.pairs = pairs
        self.images = [p for p, _ in pairs]

    def __len__(self) -> int:
        return len(self.pairs)

    def get(self, idx: int, rng: Optional[np.random.Generator] = None):
        rgb_path, label_path = self.pairs[idx]
        image = np.asarray(Image.open(rgb_path).convert("RGB"))
        label = np.asarray(Image.open(label_path)).astype(np.uint8)
        if self.transforms is not None and rng is not None:
            image, label = self.transforms(rng, image, label)
        pixel_values = feature_extract(image, self.input_size)
        if self.mode in ("train", "val"):
            label = cv2.resize(label, (self.input_size, self.input_size),
                               interpolation=cv2.INTER_NEAREST)
        return {"pixel_values": pixel_values,
                "labels": label.astype(np.int32)}

    def __getitem__(self, idx: int):
        return self.get(idx, np.random.default_rng(idx))
