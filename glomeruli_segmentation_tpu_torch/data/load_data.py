"""Dataset list reading and statistics (ref ``module/espnet/train/loadData.py``).

The port's own copy of ``glomeruli_segmentation_tpu/data/load_data.py``
(numpy, cv2 and PIL, the last two imported where they are used); a test
holds the two equal and has each package read the other's cache.
Replicated semantics:
- per-channel mean/std are the **mean of per-image means/stds** (BGR order
  via cv2, ``loadData.py:77-84,100-102``) — not global pixel statistics;
- class weights ``1 / ln(1.10 + normalized_histogram)``
  (``loadData.py:30-38``, ERFNet weighting);
- label range validation (``loadData.py:92-96``);
- the result dict is pickled to ``cached_data_file``
  (``loadData.py:108-134``) with the same keys.
"""
from __future__ import annotations

import os
import pickle
from typing import Dict, List

import numpy as np


class LoadData:
    def __init__(self, data_dir: str, classes: int, cached_data_file: str,
                 norm_val: float = 1.10):
        self.data_dir = data_dir
        self.classes = classes
        self.cached_data_file = cached_data_file
        self.norm_val = norm_val
        self.class_weights = np.ones(classes, dtype=np.float32)
        self.mean = np.zeros(3, dtype=np.float32)
        self.std = np.zeros(3, dtype=np.float32)
        self.train_im: List[str] = []
        self.train_annot: List[str] = []
        self.val_im: List[str] = []
        self.val_annot: List[str] = []

    def compute_class_weights(self, histogram: np.ndarray) -> None:
        norm_hist = histogram / np.sum(histogram)
        for i in range(self.classes):
            self.class_weights[i] = 1 / (np.log(self.norm_val + norm_hist[i]))

    def read_file(self, file_name: str, train_stg: bool = False) -> int:
        import cv2
        from PIL import Image

        global_hist = np.zeros(self.classes, dtype=np.float32)
        no_files = 0
        with open(file_name) as f:
            for line in f:
                if not line.strip():
                    continue
                img_file, label_file = [p.strip() for p in line.split(",")]
                label_img = np.asarray(Image.open(label_file))
                unique_values = np.unique(label_img)
                if (max(unique_values) > self.classes - 1
                        or min(unique_values) < 0):
                    print("Labels can take value between 0 and number of "
                          "classes.")
                    print("Some problem with labels. Please check.")
                    print("Label Image ID: " + label_file)
                if train_stg:
                    hist = np.histogram(label_img, self.classes)
                    global_hist += hist[0]
                    rgb = cv2.imread(img_file)
                    for c in range(3):
                        self.mean[c] += np.mean(rgb[:, :, c])
                        self.std[c] += np.std(rgb[:, :, c])
                    self.train_im.append(img_file)
                    self.train_annot.append(label_file)
                else:
                    self.val_im.append(img_file)
                    self.val_annot.append(label_file)
                no_files += 1
        if train_stg:
            self.mean /= no_files
            self.std /= no_files
            self.compute_class_weights(global_hist)
        return 0

    def process_data(self) -> Dict:
        print("Processing training data")
        r0 = self.read_file(os.path.join(self.data_dir, "train.txt"), True)
        print("Processing validation data")
        r1 = self.read_file(os.path.join(self.data_dir, "val.txt"))
        print("Pickling data")
        if r0 == 0 and r1 == 0:
            data = {
                "trainIm": self.train_im,
                "trainAnnot": self.train_annot,
                "valIm": self.val_im,
                "valAnnot": self.val_annot,
                "mean": self.mean,
                "std": self.std,
                "classWeights": self.class_weights,
            }
            with open(self.cached_data_file, "wb") as f:
                pickle.dump(data, f)
            return data
        return None

    # reference alias
    processData = process_data


def create_dataset_txt(data_dir: str) -> None:
    """Pair train/val rgb PNGs with labels and write train.txt / val.txt
    (ref ``module/espnet/train/create_dataset_txt.py``)."""
    import glob

    for split in ("train", "val"):
        rgb_dir = os.path.join(data_dir, split, "rgb")
        label_dir = os.path.join(data_dir, split, "label")
        txt_path = os.path.join(data_dir, f"{split}.txt")
        files = sorted(glob.glob(os.path.join(rgb_dir, "**/*.PNG"),
                                 recursive=True))
        with open(txt_path, "w") as f:
            for rgb_path in files:
                parts = rgb_path.split("/")
                label_path = os.path.join(label_dir, parts[-2], parts[-1])
                f.write(rgb_path + "," + label_path + "\n")
