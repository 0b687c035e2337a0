"""Fine-tune the reference's OD-API inception_v2 Faster R-CNN
(``gseg-train-detector --finetune_pb``).

Counterpart of ``glomeruli_segmentation_tpu/train/od_api_finetune.py``:
starting from the imported frozen-graph weights (or any assembled OD-API
parameter tree), it trains the architecture the reference runs,
:class:`..models.od_api_frcnn.ODAPIFasterRCNN`, with the two-stage losses
of :mod:`.detector_train`, sampling annotated-slide windows like the native
driver (:class:`.detector_driver.SlideWindowSampler`, the same windows as
the JAX package for equal ``seed``).

BN was folded into the conv weights at import (``convert/pb_import.py``),
so fine-tuning updates the folded scale and shift with frozen normalisation
statistics.  Float32 end to end with both TF32 switches off, Adam, and
``max_proposals`` 64 unless overridden; one K3 launch a step on the card.
The result is ``od_api_detector.ckpt.pth`` in the JAX package's layout
(``od_api_params``, ``num_classes``, ``od_config``), written with
``torch.save``; both packages' detect commands load it.

``data_parallel`` N splits the window batch over N ranks as the native
driver does (:mod:`.detector_driver`); with BN folded and frozen, the
ranks only sum their gradients and losses.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Optional

import numpy as np
import torch

from .. import resolve_device
from ..convert.pb_import import load_od_api_checkpoint  # noqa: F401
from ..parallel import distributed
from .detector_driver import (DetectorTrainConfig, SlideWindowSampler,
                              plan_windows, run_steps)

OD_API_CKPT_NAME = "od_api_detector.ckpt.pth"


def od_api_forward(model, x, anchors):
    return model.train_outputs(x, anchors)


def finetune_od_api(staining: str, data_dir: str, target_list: str,
                    output_dir: str,
                    config: Optional[DetectorTrainConfig] = None,
                    pb_path: Optional[str] = None,
                    consts=None, params=None,
                    num_classes: Optional[int] = None,
                    od_config_overrides: Optional[dict] = None,
                    log_every: int = 50, data_parallel: int = 0,
                    device="cuda", devices=None) -> str:
    """Fine-tune OD-API weights on annotated slides; returns the saved
    checkpoint path.  Initial weights come from ``pb_path`` (a downloaded
    frozen graph), ``consts`` (pre-extracted constants), or ``params``
    (an already-assembled tree + ``num_classes``).  ``device`` is ``cuda``
    unless the caller asks for the CPU; ``data_parallel`` trains on that
    many ranks (on ``devices``)."""
    config = config or DetectorTrainConfig()
    plan = plan_windows(data_parallel, config.batch_size, device, devices)
    return distributed.run(plan, _finetune, staining, data_dir, target_list,
                           output_dir, config, pb_path, consts, params,
                           num_classes, od_config_overrides, log_every,
                           device)


def _finetune(staining, data_dir, target_list, output_dir, config, pb_path,
              consts, params, num_classes, od_config_overrides, log_every,
              device) -> str:
    from ..convert.pb_import import (assemble_od_api_params,
                                     load_od_api_detector_params)
    from ..models.od_api_frcnn import (ODAPIConfig, ODAPIFasterRCNN,
                                       build_anchors)

    dev = distributed.rank_device() or resolve_device(device)
    if params is not None:
        assert num_classes is not None, "params requires num_classes"
    elif consts is not None:
        params, num_classes = assemble_od_api_params(consts)
    else:
        params, num_classes = load_od_api_detector_params(pb_path)

    overrides = dict(od_config_overrides or {})
    # a training step differentiates through all max_proposals ROI crops
    # at once; the inference default (300) is needlessly wide for loss
    # sampling and dominates memory -- 64 matches common fine-tune setups
    overrides.setdefault("max_proposals", 64)
    od_config = ODAPIConfig(
        num_classes=num_classes,
        image_size=(config.image_size, config.image_size), **overrides)
    # f32 end-to-end: bf16 gradients through the folded-BN trunk lose the
    # small fine-tuning updates
    model = ODAPIFasterRCNN(params, od_config,
                            compute_dtype="float32").to(dev)
    anchors = build_anchors(od_config).to(dev)

    sampler = SlideWindowSampler(staining, data_dir, target_list, config)
    rng = np.random.default_rng(config.seed)
    optimizer = torch.optim.Adam(model.parameters(), lr=config.lr,
                                 eps=1e-8)
    run_steps(sampler, rng, config.steps, model, optimizer, od_api_forward,
              anchors, dev, False, log_every)

    ckpt_path = os.path.join(output_dir, OD_API_CKPT_NAME)
    if not distributed.is_primary():
        return ckpt_path
    os.makedirs(output_dir, exist_ok=True)

    def tensors(tree):
        return {k: tensors(v) if isinstance(v, dict)
                else torch.from_numpy(v) for k, v in tree.items()}

    torch.save({
        "od_api_params": tensors(model.params_tree()),
        "num_classes": num_classes,
        "od_config": dataclasses.asdict(od_config),
    }, ckpt_path)
    return ckpt_path
