"""Training-time augmentation transforms.

The port's own copy of ``glomeruli_segmentation_tpu/data/transforms.py``
(numpy and cv2, imported where it is used); a test holds the two equal.
Native reimplementation of the upstream-ESPNet ``Transforms`` module the
reference imports (``module/espnet/train/main.py:10,270-326``):

- ``Normalize(mean, std)`` — subtract/divide in the 0..255 BGR domain
- ``Scale(w, h)`` — bilinear image, nearest label
- ``RandomCropResize(n)`` — with p=1/2 crop up to n border pixels and resize
  back
- ``RandomFlip`` — horizontal flip with p=1/2
- ``RandomVerticalFlip`` / ``RandomBlurringAndSharpning`` /
  ``RandomContrast`` — SegFormer-variant extras
  (``module/SegFormer/train/train.py:161-172``)
- ``ToTensor(scaleIn)`` — downsample the *label* by scaleIn (8 when training
  the encoder whose output is 1/8 resolution), divide image by 255.  Images
  stay NHWC numpy; the trainer moves them to NCHW on the device.

All randomness comes from an explicit ``numpy.random.Generator`` so the
host input pipeline is reproducible and parallelizable.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np

Pair = Tuple[np.ndarray, np.ndarray]


class Compose:
    def __init__(self, transforms: Sequence):
        self.transforms = list(transforms)

    def __call__(self, rng: np.random.Generator, image, label) -> Pair:
        for t in self.transforms:
            image, label = t(rng, image, label)
        return image, label


class Normalize:
    def __init__(self, mean, std):
        self.mean = np.asarray(mean, np.float32)
        self.std = np.asarray(std, np.float32)

    def __call__(self, rng, image, label) -> Pair:
        image = image.astype(np.float32)
        image -= self.mean
        image /= self.std
        return image, label


class Scale:
    def __init__(self, w: int, h: int):
        self.w, self.h = w, h

    def __call__(self, rng, image, label) -> Pair:
        import cv2

        image = cv2.resize(image, (self.w, self.h))
        label = cv2.resize(label, (self.w, self.h),
                           interpolation=cv2.INTER_NEAREST)
        return image, label


class RandomCropResize:
    """Randomly crop up to ``crop_area`` border pixels, resize back."""

    def __init__(self, crop_area: int):
        self.crop_area = crop_area

    def __call__(self, rng, image, label) -> Pair:
        if rng.random() < 0.5:
            import cv2

            h, w = image.shape[:2]
            # clamp so the crop never collapses on small inputs
            max_x = min(self.crop_area, (w - 1) // 2)
            max_y = min(self.crop_area, (h - 1) // 2)
            x = int(rng.integers(0, max_x + 1))
            y = int(rng.integers(0, max_y + 1))
            img_crop = image[y: h - y, x: w - x]
            lbl_crop = label[y: h - y, x: w - x]
            image = cv2.resize(img_crop, (w, h))
            label = cv2.resize(lbl_crop, (w, h),
                               interpolation=cv2.INTER_NEAREST)
        return image, label


class RandomFlip:
    def __call__(self, rng, image, label) -> Pair:
        if rng.random() < 0.5:
            image = np.ascontiguousarray(image[:, ::-1])
            label = np.ascontiguousarray(label[:, ::-1])
        return image, label


class RandomVerticalFlip:
    def __call__(self, rng, image, label) -> Pair:
        if rng.random() < 0.5:
            image = np.ascontiguousarray(image[::-1])
            label = np.ascontiguousarray(label[::-1])
        return image, label


class RandomBlurringAndSharpning:
    def __call__(self, rng, image, label) -> Pair:
        r = rng.random()
        if r < 2 / 3:
            import cv2

            if r < 1 / 3:
                image = cv2.GaussianBlur(image, (5, 5), 0)
            else:
                kernel = np.array([[0, -1, 0], [-1, 5, -1], [0, -1, 0]],
                                  np.float32)
                image = cv2.filter2D(image, -1, kernel)
        return image, label


class RandomContrast:
    def __init__(self, low: float = 0.7, high: float = 1.3):
        self.low, self.high = low, high

    def __call__(self, rng, image, label) -> Pair:
        if rng.random() < 0.5:
            alpha = rng.uniform(self.low, self.high)
            mean = image.mean()
            image = np.clip((image - mean) * alpha + mean, 0, 255)
            if image.dtype != np.float32:
                image = image.astype(np.uint8)
        return image, label


class ToTensor:
    """Final packaging: image/255 float32 NHWC, label int32 (optionally
    downsampled by scale_in to match the encoder's 1/8 output)."""

    def __init__(self, scale_in: int = 1):
        self.scale_in = scale_in

    def __call__(self, rng, image, label) -> Pair:
        if self.scale_in != 1:
            import cv2

            h, w = label.shape[:2]
            label = cv2.resize(label, (w // self.scale_in,
                                       h // self.scale_in),
                               interpolation=cv2.INTER_NEAREST)
        image = image.astype(np.float32) / 255.0
        return image, label.astype(np.int32)
