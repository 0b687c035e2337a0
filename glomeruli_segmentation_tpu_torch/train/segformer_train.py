"""SegFormer (GTCS) fine-tuning loop (ref ``module/SegFormer/train/train.py``).

Counterpart of ``glomeruli_segmentation_tpu/train/segformer_train.py`` on
the port's plain ``nn.Module`` and autograd.  Replicated recipe:

- augmentations: RandomCropResize(64), H/V flips, blur/sharpen, contrast
  (``train.py:161-172``);
- ``--pretrained_checkpoint``: the checkpoint's MiT geometry with
  ``num_labels`` from the flag; every tensor whose name and shape match is
  adopted, everything else (a backbone-only checkpoint's head, a
  classifier of another width) keeps the fresh init;
- AdamW with optax's defaults (betas 0.9/0.999, eps 1e-8, weight decay
  1e-4 on every parameter — not torch's 0.01) and optax's
  ``linear_schedule(0, lr, warmup)``: a warm-up over ``epoch_steps *
  save_interval`` optimizer steps that then holds at ``lr``; the first
  update runs at lr 0;
- ``--accumulation_steps k`` as ``optax.MultiSteps``: the mean of k
  micro-batch gradients, one optimizer and schedule step per k; BN
  statistics update on every micro-batch;
- the loss: the f32 logits upsampled to label size (``upsample_logits``,
  the JAX blend) and cross entropy ignoring label 255, the summed
  entropy over ``max(count, 1)`` (``_ce_ignore_sums``);
- evaluation every save interval and on the last epoch with mean-IoU
  (ignore_index 255); ``checkpoint-{step}/flax_model.pth`` (``step``
  counts micro-batches), keeping the newest and the best
  (``save_total_limit=2``); ``log.txt`` JSON lines ``{"loss", "epoch"}``
  and ``{"eval_mean_iou", "epoch"}``, which the best-checkpoint discovery
  of ``gseg-segformer-test`` reads.

Float32 steps run with both TF32 switches off from the forward through
the optimizer step; ``--bf16`` autocasts the forward only.

``--data_parallel`` and the coordinator flags train on the ranks of
``parallel/distributed.py``, as the JAX trainer trains on its mesh: a
ragged batch is padded to a multiple of the ranks, images by repeating the
last one and labels with 255, so the padded rows stay out of the loss
(the head's BatchNorm statistics, global over the ranks, still see them);
the loss's numerator and pixel count are sums over the ranks, with
``max(count, 1)`` on the global count; the gradients are summed over the
ranks at each optimizer step; evaluation gathers every rank's predictions,
so that ``mean_iou`` sees the whole batch, as the JAX trainer's replicated
eval output gives it.  Rank 0 writes ``log.txt`` and the checkpoints.
"""
from __future__ import annotations

import dataclasses
import json
import os
import shutil
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from .. import resolve_device, tf32
from ..data import transforms as T
from ..data.dataset import DataLoader
from ..eval.mean_iou import mean_iou
from ..models.segformer import (
    Segformer,
    SegformerConfig,
    config_from_state_dict,
    upsample_logits,
)
from ..parallel import distributed
from .batch_norm import use_flax_batch_norm
from .espnet_train import autocast, upload

# optax.adamw's defaults
ADAMW_BETAS, ADAMW_EPS, ADAMW_WEIGHT_DECAY = (0.9, 0.999), 1e-8, 1e-4


def _ce_ignore_sums(logits_up: torch.Tensor, labels: torch.Tensor,
                    ignore_index: int = 255):
    """The summed float32 cross entropy of (N, H, W, C) logits against (N,
    H, W) labels over the pixels whose label is not ``ignore_index``, and
    the count of those pixels."""
    logp = F.log_softmax(logits_up.float(), dim=-1)
    labels = labels.long()
    safe = torch.where(labels == ignore_index, 0, labels)
    nll = -logp.gather(-1, safe.unsqueeze(-1)).squeeze(-1)
    mask = labels != ignore_index
    return (nll * mask).sum(), mask.sum()


def pad_batch(x: np.ndarray, y: Optional[np.ndarray]):
    """Pad a ragged batch to a multiple of the data axis (JAX
    ``segformer_train._pad_batch``): images repeat the last one, labels
    are 255.  Returns (x, y, the number of real rows)."""
    n = x.shape[0]
    pad = distributed.pad_rows(n)
    if pad:
        x = np.concatenate([x, np.repeat(x[-1:], pad, axis=0)])
        if y is not None:
            y = np.concatenate(
                [y, np.full((pad,) + y.shape[1:], 255, y.dtype)])
    return x, y, n


def warmup_lr(lr: float, warmup: int, count: int) -> float:
    """``optax.linear_schedule(0, lr, warmup)`` at optimizer step
    ``count``: a linear warm-up from 0 that then holds at ``lr``."""
    return lr * min(count, warmup) / warmup


def build_steps(model: torch.nn.Module, optimizer, lr: float, warmup: int,
                accumulation_steps: int = 1, bf16: bool = False):
    """(train_step, eval_step) over ``model`` on its device.

    ``train_step(x, y)`` takes one (N, H, W, 3) float batch and its (N, H,
    W) labels on the device (in a data axis, this rank's rows), runs the
    forward in training mode, the f32 upsample and loss, and the backward;
    every ``accumulation_steps``-th call it sums the gradients over the
    ranks and steps AdamW at the schedule's lr on the mean of the
    gradients and clears them.  It returns the micro-batch's loss (of the
    global batch) on the device.  ``eval_step(x)`` returns the
    evaluation-mode logits (N, h, w, C)."""
    k = max(1, int(accumulation_steps))
    device = next(model.parameters()).device
    state = {"micro": 0, "updates": 0}

    def train_step(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        model.train()
        # both TF32 switches off from the forward through the optimizer
        # step, under the port's TF32 lock
        with tf32(False, False):
            with autocast(device, bf16):
                logits = model(x)
            up = upsample_logits(logits.float(), y.shape[1], y.shape[2])
            share, loss = distributed.global_ratio(*_ce_ignore_sums(up, y),
                                                   floor=1)
            (share / k if k > 1 else share).backward()
            state["micro"] += 1
            if state["micro"] % k == 0:
                distributed.reduce_gradients(model)
                for group in optimizer.param_groups:
                    group["lr"] = warmup_lr(lr, warmup, state["updates"])
                optimizer.step()
                optimizer.zero_grad(set_to_none=True)
                state["updates"] += 1
        return loss

    @torch.no_grad()
    def eval_step(x: torch.Tensor) -> torch.Tensor:
        model.eval()
        with tf32(False, False), autocast(device, bf16):
            return model(x)

    return train_step, eval_step


def _pair_collate(items):
    return (np.stack([it["pixel_values"] for it in items]),
            np.stack([it["labels"] for it in items]))


def _PairLoader(dataset, batch_size, shuffle, num_workers, seed=0,
                prefetch: int = 1):
    """Adapts ResizedGlomerularDataset dicts to (image, label) batches:
    the shared DataLoader (epoch-seeded shuffle, threaded decode, bounded
    producer-thread prefetch) with a dict collate."""
    return DataLoader(dataset, batch_size, shuffle=shuffle,
                      num_workers=num_workers, seed=seed, prefetch=prefetch,
                      collate=_pair_collate)


def _fresh_model(config: SegformerConfig) -> Segformer:
    """A Segformer of torch's default init under seed 0, float32."""
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        return Segformer(config)


def build_model(args) -> Segformer:
    """The model to fine-tune: mit-b0 geometry, or the geometry of
    ``--pretrained_checkpoint`` with its matching tensors adopted."""
    config = SegformerConfig(num_labels=args.num_labels)
    path = getattr(args, "pretrained_checkpoint", None)
    if not path:
        return _fresh_model(config)
    from ..convert.segformer_import import load_segformer_state_dict

    pretrained = load_segformer_state_dict(path, backbone_only=True)
    config = dataclasses.replace(config_from_state_dict(pretrained),
                                 num_labels=args.num_labels)
    model = _fresh_model(config)
    merged = model.state_dict()
    n_loaded = 0
    for name, init in merged.items():
        pre = pretrained.get(name)
        if pre is None or name.endswith("num_batches_tracked"):
            continue
        if tuple(pre.shape) == tuple(init.shape):
            merged[name] = pre.to(init.dtype)
            n_loaded += 1
        else:
            print(f"pretrained shape mismatch at {name}: "
                  f"{tuple(pre.shape)} vs {tuple(init.shape)}; "
                  "keeping random init")
    model.load_state_dict(merged, strict=True)
    print(f"pretrained checkpoint loaded ({n_loaded} tensors adopted)")
    return model


def train_segformer(args, device=None, devices=None) -> str:
    """Run fine-tuning; returns the output directory.  With
    ``--data_parallel`` or a coordinator, on the ranks of
    ``parallel/distributed.py`` (on ``devices``, by default the visible
    cards or, under the CPU, the CPU)."""
    device = device if device is not None else getattr(args, "device",
                                                       "cuda")
    plan = distributed.init_distributed(
        getattr(args, "coordinator", None),
        getattr(args, "num_processes", None),
        getattr(args, "process_id", None),
        getattr(args, "data_parallel", 0), device, devices)
    return distributed.run(plan, _train, args, device)


def _train(args, device) -> str:
    from ..convert.segformer_import import save_flax_checkpoint
    from ..data.segformer_dataset import ResizedGlomerularDataset

    dev = distributed.rank_device() or resolve_device(device)
    primary = distributed.is_primary()
    out_dir = os.path.join(args.model_root, args.site,
                           f"{args.output_dir}/fold{args.fold}")
    if primary:
        os.makedirs(out_dir, exist_ok=True)
    log_f = open(os.path.join(out_dir, "log.txt"), "a") if primary \
        else open(os.devnull, "w")

    data_source = os.path.join(args.data_root, args.site, args.data_date)
    train_tf = T.Compose([
        T.RandomCropResize(64),
        T.RandomFlip(),
        T.RandomVerticalFlip(),
        T.RandomBlurringAndSharpning(),
        T.RandomContrast(),
    ])
    input_size = getattr(args, "input_size", 512)
    train_ds = ResizedGlomerularDataset(
        data_source, rgb_subdir="rgb", label_subdir="label/gtcs",
        transforms=train_tf, mode="train", fold=args.fold,
        input_size=input_size)
    val_ds = ResizedGlomerularDataset(
        data_source, rgb_subdir="rgb", label_subdir="label/gtcs",
        transforms=None, mode="val", fold=args.fold,
        input_size=input_size)
    print(f"Number of training examples: {len(train_ds)}")
    print(f"Number of validation examples: {len(val_ds)}")
    if len(train_ds) == 0:
        raise ValueError(
            f"fold {args.fold} train split is empty: no paired crops "
            f"under {data_source}/rgb/*/[name].PNG with labels in "
            f"label/gtcs (the dataset matches uppercase .PNG, the "
            f"reference extension)")

    model = use_flax_batch_norm(build_model(args)).to(dev)
    epoch_steps = max(1, -(-len(train_ds) // args.batch_size))
    warmup = epoch_steps * args.save_interval
    optimizer = torch.optim.AdamW(model.parameters(), lr=0.0,
                                  betas=ADAMW_BETAS, eps=ADAMW_EPS,
                                  weight_decay=ADAMW_WEIGHT_DECAY)
    train_step, eval_step = build_steps(
        model, optimizer, args.lr, warmup,
        getattr(args, "accumulation_steps", 1) or 1,
        bool(getattr(args, "bf16", False)))

    prefetch = getattr(args, "prefetch", 1)
    train_loader = _PairLoader(train_ds, args.batch_size, True,
                               args.dl_num_workers, prefetch=prefetch)
    val_loader = _PairLoader(val_ds, args.batch_size, False,
                             args.dl_num_workers, prefetch=prefetch)

    best_iou = -1.0
    best_dir: Optional[str] = None
    prev_dir: Optional[str] = None
    step = 0
    losses = []
    for epoch in range(args.max_epoch):
        for x, y in train_loader:
            x, y, _ = pad_batch(x, y)
            loss = train_step(upload(distributed.shard_rows(x), dev),
                              upload(distributed.shard_rows(y), dev))
            losses.append(loss)
            step += 1
        log_f.write(json.dumps({"loss": float(loss),
                                "epoch": epoch + 1}) + "\n")
        if (epoch + 1) % args.save_interval == 0 or epoch + 1 == args.max_epoch:
            preds, gts = [], []
            for x, y in val_loader:
                xp, _, n_real = pad_batch(x, None)
                logits = eval_step(upload(distributed.shard_rows(xp), dev))
                up = upsample_logits(logits.float(), y.shape[1], y.shape[2])
                pred = distributed.gather_rows(up.argmax(-1))
                preds.extend(pred.cpu().numpy()[:n_real])
                gts.extend(y)
            if preds:
                metrics = mean_iou(preds, gts, args.num_labels,
                                   ignore_index=255)
                eval_iou = float(metrics["mean_iou"])
            else:
                eval_iou = 0.0
            log_f.write(json.dumps(
                {"eval_mean_iou": eval_iou, "epoch": epoch + 1}) + "\n")
            log_f.flush()
            if not primary:
                continue
            ckpt_dir = os.path.join(out_dir, f"checkpoint-{step}")
            os.makedirs(ckpt_dir, exist_ok=True)
            save_flax_checkpoint(model.state_dict(),
                                 os.path.join(ckpt_dir, "flax_model.pth"),
                                 args.num_labels)
            # save_total_limit=2: keep the newest and the best
            if eval_iou > best_iou:
                best_iou = eval_iou
                if (best_dir and prev_dir and best_dir != prev_dir
                        and os.path.isdir(best_dir)):
                    shutil.rmtree(best_dir)
                best_dir = ckpt_dir
            elif prev_dir and prev_dir != best_dir and os.path.isdir(prev_dir):
                shutil.rmtree(prev_dir)
            prev_dir = ckpt_dir
    log_f.close()
    distributed.report(losses=[float(v) for v in losses])
    return out_dir
