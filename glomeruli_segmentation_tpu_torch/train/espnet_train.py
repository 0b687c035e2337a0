"""ESPNet training loop (ref ``module/espnet/train/main.py``).

Counterpart of ``glomeruli_segmentation_tpu/train/espnet_train.py``,
section by section, on the port's plain ``nn.Module``s and autograd (the
JAX trainer differentiates its plain Flax model too; no kernel of the
repo lies on this path):

- pickle-cached dataset statistics and ``1/ln(1.10+p)`` class weights
  (``main.py:203-211``, loadData)
- encoder vs decoder model with savedir suffix ``_enc_p_q`` / ``_dec_p_q``
  (``main.py:217-222``); a decoder run loads its encoder from
  ``--pretrained``
- five multi-scale train pipelines + val pipeline with the reference's
  exact sizes, crop sizes and batch-size offsets (``main.py:270-353``)
- Adam(lr=5e-4, betas=(0.9, 0.999), eps=1e-8) with torch's coupled L2
  weight decay (``--weight_decay``, reference default 5e-4,
  ``main.py:382``) and StepLR(step=step_loss, gamma=0.5), set per epoch
- BatchNorm's running statistics updated with the biased batch variance,
  as Flax does (:mod:`.batch_norm`)
- per epoch: train on scale1, scale2, scale4, scale3, main — in that order
  (``main.py:396-406``) — then validate; biased per-batch-mean metrics in
  the logs, matching ``getMetric`` (``IOUEval.py:55-61``); the confusion
  histogram is taken on the device and only it and the loss are read back
- artifacts: ``checkpoint.pth.tar``, ``model_{epoch}.pth`` (the reference
  key layout, which the JAX package's ``load_torch_pickle`` reads),
  ``acc_{epoch}.txt``, ``trainValLog.txt``, ``mean_std.txt``, ``model.txt``
  (``main.py:263-266,373-443``), and the port's full-state checkpoint
  ``torch_full_state.pth`` (model, Adam state, epoch) for ``--resume``

Float32 steps run with both TF32 switches off from the forward through
the backward and the optimizer step; ``--bf16`` autocasts the forward only
(parameters, gradients, Adam state and BN statistics stay float32, and the
loss reduces in float32).  The multi-card flags (``--data_parallel``,
``--coordinator``, ``--num_processes``, ``--process_id``) are not ported
and raise.
"""
from __future__ import annotations

import contextlib
import os
import pickle
import time
from functools import partial
from typing import Optional

import numpy as np
import torch

from .. import read_host, readback, resolve_device, tf32
from ..convert.espnet_import import load_espnet_state_dict
from ..data import transforms as T
from ..data.dataset import DataLoader, SegmentationDataset
from ..data.load_data import LoadData
from ..eval.iou_eval import IouEval, confusion_matrix
from ..models.espnet import ESPNet, ESPNetEncoder
from .batch_norm import use_flax_batch_norm
from .criteria import cross_entropy_2d

# the port's own full-state checkpoint (the JAX trainer's is the orbax
# directory ``native_ckpt``; neither reads the other's)
FULL_STATE = "torch_full_state.pth"
# the order in which each epoch runs the training scales
TRAIN_SCALES = ("scale1", "scale2", "scale4", "scale3", "main")


def refuse_unported(args) -> None:
    """The multi-card flags raise ``SystemExit`` naming themselves."""
    unported = [name for name, val in (
        ("--data_parallel", getattr(args, "data_parallel", 0) or 0),
        ("--coordinator", getattr(args, "coordinator", None)),
        ("--num_processes", getattr(args, "num_processes", None)),
        ("--process_id", getattr(args, "process_id", None)),
    ) if val]
    if unported:
        raise SystemExit("not ported: " + ", ".join(unported))


def net_params(model: torch.nn.Module) -> int:
    return sum(p.numel() for p in model.parameters())


def upload(arr: np.ndarray, device: torch.device) -> torch.Tensor:
    """A host batch as a tensor on ``device``: on a card copied from pinned
    memory without waiting (torch's host allocator reuses no pinned block
    before the copy that reads it has run); on the CPU a view."""
    t = torch.from_numpy(np.ascontiguousarray(arr))
    if device.type != "cuda":
        return t
    return t.pin_memory().to(device, non_blocking=True)


def nchw(x: torch.Tensor) -> torch.Tensor:
    """An NHWC image batch as a contiguous NCHW one, on its device."""
    return x.permute(0, 3, 1, 2).contiguous()


def autocast(device: torch.device, bf16: bool):
    """bf16 autocast of a forward, or nothing."""
    if not bf16:
        return contextlib.nullcontext()
    return torch.autocast(device.type, dtype=torch.bfloat16)


def state_dict_cpu(model: torch.nn.Module) -> dict:
    """The model's state dict as CPU tensors, ``num_batches_tracked`` 0."""
    return {k: v.detach().cpu().clone() for k, v in
            model.state_dict().items()}


class EspnetTrainer:
    def __init__(self, args, device=None):
        refuse_unported(args)
        self.args = args
        self.device = resolve_device(
            device if device is not None else getattr(args, "device",
                                                      "cuda"))
        self.bf16 = bool(getattr(args, "bf16", False))
        self.class_weights: Optional[torch.Tensor] = None
        # one row per training step: (scale, batch shape, loader wait s,
        # step s, ending with the loss and histogram read back)
        self.timings = []

    # ---------------- setup ----------------
    def load_data(self):
        args = self.args
        if not os.path.isfile(args.cached_data_file):
            data = LoadData(args.data_dir, args.classes,
                            args.cached_data_file).process_data()
            if data is None:
                raise SystemExit("Error while pickling data. Please check.")
            return data
        with open(args.cached_data_file, "rb") as f:
            return pickle.load(f)

    def build_loaders(self, data):
        args = self.args
        mean, std = data["mean"], data["std"]
        scale_in = args.scaleIn

        def pipeline(w, h, crop: Optional[int]):
            steps = [T.Normalize(mean, std), T.Scale(w, h)]
            if crop is not None:
                steps.append(T.RandomCropResize(crop))
            steps.append(T.RandomFlip())
            steps.append(T.ToTensor(scale_in))
            return T.Compose(steps)

        train_ds = partial(SegmentationDataset, data["trainIm"],
                           data["trainAnnot"])
        bs = args.batch_size
        prefetch = getattr(args, "prefetch", 1)
        loaders = {
            "scale1": DataLoader(train_ds(pipeline(1536, 768, 100)), bs,
                                 num_workers=args.num_workers, seed=1,
                                 prefetch=prefetch),
            "scale2": DataLoader(train_ds(pipeline(1280, 720, 100)), bs,
                                 num_workers=args.num_workers, seed=2,
                                 prefetch=prefetch),
            "scale4": DataLoader(train_ds(pipeline(512, 256, None)), bs + 4,
                                 num_workers=args.num_workers, seed=4,
                                 prefetch=prefetch),
            "scale3": DataLoader(train_ds(pipeline(768, 384, 32)), bs + 4,
                                 num_workers=args.num_workers, seed=3,
                                 prefetch=prefetch),
            "main": DataLoader(train_ds(pipeline(1024, 512, 32)), bs + 2,
                               num_workers=args.num_workers, seed=0,
                               prefetch=prefetch),
        }
        val_tf = T.Compose([T.Normalize(mean, std), T.Scale(1024, 512),
                            T.ToTensor(scale_in)])
        loaders["val"] = DataLoader(
            SegmentationDataset(data["valIm"], data["valAnnot"], val_tf),
            bs + 4, shuffle=False, num_workers=args.num_workers,
            prefetch=prefetch)
        return loaders

    def build_model(self) -> torch.nn.Module:
        """A freshly initialised model (torch's default init under seed 0)
        with the Flax BatchNorm update, on the trainer's device; suffixes
        ``args.savedir``."""
        args = self.args
        cls = ESPNet if args.decoder else ESPNetEncoder
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(0)
            model = cls(args.classes, args.p, args.q)
        part = "dec" if args.decoder else "enc"
        args.savedir = args.savedir + f"_{part}_{args.p}_{args.q}/"
        return use_flax_batch_norm(model).to(self.device)

    def build_optimizer(self, model: torch.nn.Module):
        """torch Adam with ``weight_decay`` couples L2 into the gradient
        before the moment updates (``main.py:382``), as the JAX package's
        ``add_decayed_weights`` + ``adam`` chain does."""
        args = self.args
        weight_decay = float(getattr(args, "weight_decay", 5e-4))
        return torch.optim.Adam(model.parameters(), lr=args.lr,
                                betas=(0.9, 0.999), eps=1e-8,
                                weight_decay=weight_decay)

    def lr_at(self, epoch: int) -> float:
        args = self.args
        return args.lr * (0.5 ** (epoch // args.step_loss))

    # ---------------- steps ----------------
    def train_step(self, model, optimizer, x: torch.Tensor, y: torch.Tensor,
                   valid: Optional[torch.Tensor] = None):
        """One step on an NCHW batch on the device: forward in train mode,
        the f32 loss from f32 logits, backward, Adam.  Returns the loss and
        the KxK confusion histogram of the forward's argmax, on the
        device."""
        model.train()
        # both TF32 switches off, held under the port's TF32 lock from the
        # forward through the backward (which autograd dispatches later)
        # and the optimizer step
        with tf32(False, False):
            optimizer.zero_grad(set_to_none=True)
            with autocast(self.device, self.bf16):
                logits = model(x)
            logits = logits.float()
            loss = cross_entropy_2d(logits, y, self.class_weights, valid)
            loss.backward()
            optimizer.step()
        hist = confusion_matrix(logits.detach().argmax(1), y,
                                logits.shape[1], sample_valid=valid)
        return loss.detach(), hist

    @torch.no_grad()
    def val_step(self, model, x: torch.Tensor, y: torch.Tensor,
                 valid: Optional[torch.Tensor] = None):
        model.eval()
        with tf32(False, False):
            with autocast(self.device, self.bf16):
                logits = model(x)
            logits = logits.float()
            loss = cross_entropy_2d(logits, y, self.class_weights, valid)
        hist = confusion_matrix(logits.argmax(1), y, logits.shape[1],
                                sample_valid=valid)
        return loss, hist

    def _read(self, loss: torch.Tensor, hist: torch.Tensor):
        """The loss and the histogram on the host, through one readback."""
        flat = torch.cat([hist.reshape(-1).double(), loss.double()[None]])
        out = read_host(readback(flat))
        k = hist.shape[0]
        return float(out[-1]), out[:-1].astype(np.int64).reshape(k, k)

    def train_epoch(self, model, optimizer, loader, scale: str = "main"):
        args = self.args
        iou_eval = IouEval(args.classes)
        losses = []
        total = len(loader)
        t_wait = time.perf_counter()
        for i, (x, y) in enumerate(loader):
            t0 = time.perf_counter()
            loss, hist = self.train_step(
                model, optimizer, nchw(upload(x, self.device)),
                upload(y, self.device))
            loss, hist = self._read(loss, hist)
            t1 = time.perf_counter()
            self.timings.append((scale, tuple(x.shape), t0 - t_wait,
                                 t1 - t0))
            losses.append(loss)
            iou_eval.add_hist(hist)
            print("[%d/%d] loss: %.3f time:%.2f" % (i, total, loss,
                                                    t1 - t0))
            t_wait = time.perf_counter()
        overall_acc, per_class_acc, per_class_iou, miou = iou_eval.get_metric()
        return (sum(losses) / max(len(losses), 1), overall_acc,
                per_class_acc, per_class_iou, miou)

    def val_epoch(self, model, loader):
        args = self.args
        iou_eval = IouEval(args.classes)
        losses = []
        for x, y in loader:
            loss, hist = self._read(*self.val_step(
                model, nchw(upload(x, self.device)), upload(y, self.device)))
            losses.append(loss)
            iou_eval.add_hist(hist)
        overall_acc, per_class_acc, per_class_iou, miou = iou_eval.get_metric()
        return (sum(losses) / max(len(losses), 1), overall_acc,
                per_class_acc, per_class_iou, miou)

    # ---------------- checkpoints ----------------
    def _save_full_state(self, model, optimizer, epoch: int) -> None:
        path = os.path.join(self.args.savedir, FULL_STATE)
        torch.save({"model": state_dict_cpu(model),
                    "optimizer": optimizer.state_dict(), "epoch": epoch},
                   path + ".tmp")
        os.replace(path + ".tmp", path)

    def _resume(self, model, optimizer) -> int:
        """Restore from the port's full state, else the weights of
        ``--resumeLoc`` (also a JAX trainer's ``checkpoint.pth.tar``);
        returns the epoch to start from."""
        args = self.args
        full = os.path.join(args.savedir, FULL_STATE)
        if os.path.isfile(full):
            state = torch.load(full, map_location=self.device,
                               weights_only=True)
            model.load_state_dict(state["model"], strict=True)
            optimizer.load_state_dict(state["optimizer"])
            print("=> restored full-state checkpoint (epoch {})".format(
                state["epoch"]))
            return int(state["epoch"])
        if os.path.isfile(args.resumeLoc):
            ckpt = torch.load(args.resumeLoc, map_location="cpu",
                              weights_only=True)
            start_epoch = int(ckpt["epoch"])
            model.load_state_dict(
                {k: torch.as_tensor(v) for k, v in
                 ckpt["state_dict"].items()}, strict=True)
            print("=> loaded checkpoint (epoch {})".format(start_epoch))
            return start_epoch
        print("=> no checkpoint found at '{}'".format(args.resumeLoc))
        return 0

    # ---------------- the training run ----------------
    def run(self):
        args = self.args
        data = self.load_data()
        model = self.build_model()
        os.makedirs(args.savedir, exist_ok=True)

        self.class_weights = torch.as_tensor(
            np.asarray(data["classWeights"], np.float32), device=self.device)
        print("Data statistics")
        print(data["mean"], data["std"])
        print(data["classWeights"])
        with open(os.path.join(args.savedir, "mean_std.txt"), "w") as f:
            f.write("mean[B G R]: {}\n".format(data["mean"]))
            f.write("std[B G R]: {}".format(data["std"]))

        loaders = self.build_loaders(data)

        if args.decoder and args.pretrained and os.path.isfile(args.pretrained):
            model.encoder.load_state_dict(
                load_espnet_state_dict(args.pretrained), strict=True)
            print("Encoder loaded!")

        total_params = net_params(model)
        print("Total network parameters: " + str(total_params))
        if getattr(args, "visualizeNet", False):
            # graph rendering equivalent (reference: VisualizeGraph.make_dot,
            # main.py:236-244): structured per-module summary
            from ..utils.summary import model_summary

            tree = {}
            for name, p in model.named_parameters():
                *path, leaf = name.split(".")
                node = tree
                for part in path:
                    node = node.setdefault(part, {})
                node[leaf] = p.detach()
            with open(os.path.join(args.savedir, "model.txt"), "w") as f:
                f.write(model_summary(tree))

        optimizer = self.build_optimizer(model)
        start_epoch = self._resume(model, optimizer) if args.resume else 0

        log_path = os.path.join(args.savedir, args.logFile)
        new_log = not os.path.isfile(log_path)
        logger = open(log_path, "a" if not new_log else "w")
        if new_log:
            logger.write("Parameters: %s" % (str(total_params)))
            logger.write("\n%s\t%s\t%s\t%s\t%s\t%s\t" % (
                "Epoch", "Loss (train)", "Loss (val)", "mIoU (train)",
                "mIoU (val)", "Learning rate"))
        logger.flush()

        for epoch in range(start_epoch, args.max_epochs):
            lr = self.lr_at(epoch)
            for group in optimizer.param_groups:
                group["lr"] = lr
            print("Learning rate: " + str(lr))

            for name in TRAIN_SCALES[:-1]:
                print(name)
                self.train_epoch(model, optimizer, loaders[name], name)
            print("scale main")
            (loss_tr, overall_acc_tr, per_class_acc_tr, per_class_iou_tr,
             miou_tr) = self.train_epoch(model, optimizer, loaders["main"])
            print("validation")
            (loss_val, overall_acc_val, per_class_acc_val, per_class_iou_val,
             miou_val) = self.val_epoch(model, loaders["val"])

            self._save_full_state(model, optimizer, epoch + 1)
            state_dict = state_dict_cpu(model)
            torch.save({
                "epoch": epoch + 1,
                "arch": repr(model),
                "state_dict": state_dict,
                "lossTr": float(loss_tr),
                "lossVal": float(loss_val),
                "iouTr": float(miou_tr),
                "iouVal": float(miou_val),
                "lr": lr,
            }, os.path.join(args.savedir, "checkpoint.pth.tar"))
            torch.save(state_dict,
                       os.path.join(args.savedir, f"model_{epoch + 1}.pth"))

            with open(os.path.join(args.savedir, f"acc_{epoch}.txt"),
                      "w") as log:
                log.write(
                    "\nEpoch: %d\t Overall Acc (Tr): %.4f\t Overall Acc "
                    "(Val): %.4f\t mIOU (Tr): %.4f\t mIOU (Val): %.4f"
                    % (epoch, overall_acc_tr, overall_acc_val, miou_tr,
                       miou_val))
                log.write("\n")
                log.write("Per Class Training Acc: " + str(per_class_acc_tr))
                log.write("\n")
                log.write("Per Class Validation Acc: "
                          + str(per_class_acc_val))
                log.write("\n")
                log.write("Per Class Training mIOU: " + str(per_class_iou_tr))
                log.write("\n")
                log.write("Per Class Validation mIOU: "
                          + str(per_class_iou_val))

            logger.write("\n%d\t%.4f\t%.4f\t%.4f\t%.4f\t%.7f"
                         % (epoch, loss_tr, loss_val, miou_tr, miou_val, lr))
            logger.flush()
            print("Epoch : " + str(epoch) + " Details")
            print("\nEpoch No.: %d\tTrain Loss = %.4f\tVal Loss = %.4f\t "
                  "mIOU(tr) = %.4f\t mIOU(val) = %.4f"
                  % (epoch, loss_tr, loss_val, miou_tr, miou_val))
        logger.close()
        return self


def train_validate_segmentation(args, device=None) -> EspnetTrainer:
    return EspnetTrainer(args, device).run()
