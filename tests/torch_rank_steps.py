"""What the port's distributed tests run inside ranks.

``parallel/distributed.launch`` pickles a rank's function by reference, so
the ranks import this module: it imports torch, numpy and the port only,
never JAX.  Each function reports its results through
``distributed.report``, read by the tests from
``distributed.last_reports`` (one dict per rank), and returns them, so that
a test calls the same function for the one-device run."""
import time
from argparse import Namespace

import numpy as np
import torch

from glomeruli_segmentation_tpu_torch.parallel import distributed


def _numpy(tensors):
    return {k: v.detach().cpu().numpy().copy() for k, v in tensors.items()}


def _report(**values):
    distributed.report(**values)
    return values


def _flat(tree, prefix=""):
    """A nested parameter tree as (path, array) pairs, paths joined by
    ``/``."""
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", np.asarray(v)


def probe(xs, weights, rows, path):
    """The module's pieces on their own: ``AllReduceSum``'s gradient, a
    barrier that orders a file, ``is_primary``, idempotence, ``gather_rows``,
    ``global_ratio``, ``shard_rows`` and ``reduce_gradients``."""
    plan = distributed.init_distributed(data_parallel=2, device="cpu")
    r = distributed.rank()
    x = torch.tensor(xs[r], requires_grad=True)
    s = distributed.AllReduceSum.apply(x * x)
    (torch.tensor(weights[r]) * torch.tanh(s)).sum().backward()

    if distributed.is_primary():
        time.sleep(0.5)           # the other rank reaches the barrier first
        with open(path, "w") as f:
            f.write("written by rank 0")
    distributed.barrier("probe_file")
    with open(path) as f:
        seen = f.read()

    gathered = distributed.gather_rows(torch.full((2, 3), float(r + 1)))
    num = torch.tensor(float(r + 1), requires_grad=True)
    share, value = distributed.global_ratio(num, torch.tensor(4.0 * (r + 1)))
    share.backward()

    torch.manual_seed(0)
    layer = torch.nn.Linear(3, 1)
    mine = torch.from_numpy(distributed.shard_rows(rows))
    (layer(mine) ** 2).sum().backward()
    distributed.reduce_gradients(layer)
    distributed.report(
        rank=r, grad=x.grad.numpy(), seen=seen,
        primary=distributed.is_primary(), world=distributed.world(),
        same_plan=distributed.init_distributed("h:1", 5, 3, 7) == plan,
        device=str(distributed.rank_device()), gathered=gathered.numpy(),
        share=float(share), value=float(value), num_grad=float(num.grad),
        rows=mine.numpy(),
        layer_grads={k: p.grad.numpy().copy()
                     for k, p in layer.named_parameters()})


# ---------------- ESPNet ----------------
def espnet_model(sd, p=2, q=3):
    from glomeruli_segmentation_tpu_torch.models.espnet import ESPNetEncoder
    from glomeruli_segmentation_tpu_torch.train.batch_norm import (
        use_flax_batch_norm)

    model = ESPNetEncoder(5, p, q)
    model.load_state_dict(sd, strict=True)
    return use_flax_batch_norm(model)


def espnet_trainer(class_weights, lr):
    from glomeruli_segmentation_tpu_torch.train.espnet_train import (
        EspnetTrainer)

    trainer = EspnetTrainer(Namespace(lr=lr, step_loss=100,
                                      weight_decay=5e-4, data_parallel=2),
                            device="cpu")
    trainer.class_weights = torch.from_numpy(class_weights)
    return trainer


def espnet_step(sd, x, y, class_weights, lr):
    """One ``EspnetTrainer.train_step`` on this rank's rows of the padded
    batch: the loss and histogram, the summed gradients, the state after."""
    model = espnet_model(sd)
    trainer = espnet_trainer(class_weights, lr)
    optimizer = trainer.build_optimizer(model)
    xd, yd, valid = trainer._device_batch(x, y)
    loss, hist = trainer.train_step(model, optimizer, xd, yd, valid)
    return _report(
        rows=int(xd.shape[0]), valid=valid.numpy(), loss=float(loss),
        hist=hist.numpy(),
        grads={k: p.grad.numpy().copy() for k, p in model.named_parameters()},
        state=_numpy(model.state_dict()))


# ---------------- SegFormer ----------------
def segformer_steps(sd, config, batches, lr, warmup):
    """``build_steps``' train step over ``batches`` (each padded and cut to
    this rank's rows), then the eval step's gathered class map of the
    first batch: the losses, the state after, the map."""
    from glomeruli_segmentation_tpu_torch.models.segformer import (
        Segformer, upsample_logits)
    from glomeruli_segmentation_tpu_torch.train import segformer_train
    from glomeruli_segmentation_tpu_torch.train.batch_norm import (
        use_flax_batch_norm)

    model = Segformer(config)
    model.load_state_dict(sd, strict=True)
    use_flax_batch_norm(model)
    optimizer = torch.optim.AdamW(
        model.parameters(), lr=0.0, betas=segformer_train.ADAMW_BETAS,
        eps=segformer_train.ADAMW_EPS,
        weight_decay=segformer_train.ADAMW_WEIGHT_DECAY)
    train_step, eval_step = segformer_train.build_steps(model, optimizer, lr,
                                                        warmup)
    losses = []
    for x, y in batches:
        x, y, _ = segformer_train.pad_batch(x, y)
        losses.append(float(train_step(
            torch.from_numpy(distributed.shard_rows(x)),
            torch.from_numpy(distributed.shard_rows(y)))))
    x, y = batches[0]
    xp, _, n_real = segformer_train.pad_batch(x, None)
    logits = eval_step(torch.from_numpy(distributed.shard_rows(xp)))
    up = upsample_logits(logits.float(), y.shape[1], y.shape[2])
    pred = distributed.gather_rows(up.argmax(-1))[:n_real]
    return _report(losses=losses, state=_numpy(model.state_dict()),
                   pred=pred.numpy())


# ---------------- detectors ----------------
def native_step(state, config, batch, lr):
    """One native ``train_step`` on this rank's windows: the losses, the
    gradients (in the detector-state layout), the state after, the ROI
    chunk the forward took."""
    from glomeruli_segmentation_tpu_torch.models import faster_rcnn, resnet
    from glomeruli_segmentation_tpu_torch.train import detector_driver

    model = faster_rcnn.FasterRCNN(config, kernel_nms=False,
                                   train_form=True).load_state(state)
    optimizer = torch.optim.Adam(model.parameters(), lr=lr, eps=1e-8)
    x = detector_driver.upload_batch(batch, torch.device("cpu"))
    losses, proposals = detector_driver.train_step(
        model, optimizer, detector_driver.native_forward,
        faster_rcnn.build_anchors(config), x)
    return _report(
        windows=int(x[0].shape[0]), chunk=model.roi_chunk(x[0].shape[0]),
        losses={k: float(v) for k, v in losses.items()},
        proposals=proposals.numpy(),
        grads=_numpy(resnet.detector_state(
            {k: p.grad for k, p in model.named_parameters()})),
        state=_numpy(model.detector_state()))


def od_api_step(params, num_classes, overrides, image_size, batch, lr):
    """One ``--finetune_pb`` step on this rank's windows: the losses, the
    gradients and the parameters after."""
    from glomeruli_segmentation_tpu_torch.models.od_api_frcnn import (
        ODAPIConfig, ODAPIFasterRCNN, build_anchors)
    from glomeruli_segmentation_tpu_torch.train import detector_driver
    from glomeruli_segmentation_tpu_torch.train.od_api_finetune import (
        od_api_forward)

    config = ODAPIConfig(num_classes=num_classes,
                         image_size=(image_size, image_size), **overrides)
    model = ODAPIFasterRCNN(params, config, compute_dtype="float32",
                            kernel_nms=False)
    optimizer = torch.optim.Adam(model.parameters(), lr=lr, eps=1e-8)
    losses, _ = detector_driver.train_step(
        model, optimizer, od_api_forward, build_anchors(config),
        detector_driver.upload_batch(batch, torch.device("cpu")))
    params = dict(_flat(model.params_tree()))
    for p in model.parameters():
        p.data = p.grad
    return _report(losses={k: float(v) for k, v in losses.items()},
                   grads=dict(_flat(model.params_tree())), params=params)
