"""The port's ``gseg-train`` with every scale at 64x32, as a script:

    python tests/torch_train_worker.py [gseg-train flags]

``build_loaders`` is replaced when this file is imported (every scale and
the validation set at 64x32, crops and flips kept, batch 2, the trainer's
seeds), so that the ranks ``--data_parallel`` spawns, which import this
file as their main module, train on the same loaders.  Every file opened
for writing and every ``torch.save`` prints ``WRITE rank=R PATH``, so that
a test can tell which rank wrote what.  It imports torch, numpy and the
port only."""
import builtins
import os
import sys

import torch

from glomeruli_segmentation_tpu_torch.data import dataset
from glomeruli_segmentation_tpu_torch.data import transforms as t
from glomeruli_segmentation_tpu_torch.parallel import distributed
from glomeruli_segmentation_tpu_torch.train import espnet_train


def small_loaders(self, data):
    mean, std = data["mean"], data["std"]

    def pipe(crop):
        steps = [t.Normalize(mean, std), t.Scale(64, 32)]
        if crop:
            steps.append(t.RandomCropResize(crop))
        steps += [t.RandomFlip(), t.ToTensor(self.args.scaleIn)]
        return t.Compose(steps)

    def mk(crop, seed):
        return dataset.DataLoader(dataset.SegmentationDataset(
            data["trainIm"], data["trainAnnot"], pipe(crop)), 2,
            num_workers=2, seed=seed)

    loaders = {"scale1": mk(8, 1), "scale2": mk(8, 2), "scale4": mk(None, 4),
               "scale3": mk(4, 3), "main": mk(4, 0)}
    loaders["val"] = dataset.DataLoader(dataset.SegmentationDataset(
        data["valIm"], data["valAnnot"], t.Compose([
            t.Normalize(mean, std), t.Scale(64, 32),
            t.ToTensor(self.args.scaleIn)])), 2, shuffle=False,
        num_workers=2)
    return loaders


def _say_write(path):
    # an int is a file descriptor: multiprocessing's own pipes
    if not isinstance(path, int) and str(path) != os.devnull:
        print(f"WRITE rank={distributed.rank()} {path}", flush=True)


_open, _save = builtins.open, torch.save


def _recording_open(file, mode="r", *args, **kwargs):
    if any(c in mode for c in "wax+"):
        _say_write(file)
    return _open(file, mode, *args, **kwargs)


def _recording_save(obj, f, *args, **kwargs):
    _say_write(f)
    return _save(obj, f, *args, **kwargs)


espnet_train.EspnetTrainer.build_loaders = small_loaders
builtins.open = _recording_open
torch.save = _recording_save
torch.set_num_threads(1)

if __name__ == "__main__":
    from glomeruli_segmentation_tpu_torch.cli import train

    train.main(sys.argv[1:])
    print("WORKER-DONE", flush=True)
