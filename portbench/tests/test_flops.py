"""The operations per crop that ``seg_mfu`` counts, at the cells' shapes,
held to a count made another way: forward hooks on every convolution and
linear layer, plus the attention products worked out from the widths."""
import torch

from portbench import harness
from portbench.families import espnet_ensemble, segformer
from portbench.reference.espnet import ESPNet
from portbench.reference.segformer import Segformer


def hooked_flops(model, x) -> float:
    total = [0]

    def hook(m, inputs, out):
        if isinstance(m, torch.nn.ConvTranspose2d):
            k = m.out_channels * m.kernel_size[0] * m.kernel_size[1]
            total[0] += 2 * inputs[0].numel() * k
        elif isinstance(m, torch.nn.Conv2d):
            k = m.in_channels // m.groups * m.kernel_size[0] \
                * m.kernel_size[1]
            total[0] += 2 * out.numel() * k
        else:
            total[0] += 2 * out.numel() * m.in_features

    for m in model.modules():
        if isinstance(m, (torch.nn.Conv2d, torch.nn.ConvTranspose2d,
                          torch.nn.Linear)):
            m.register_forward_hook(hook)
    with torch.no_grad():
        model(x)
    return float(total[0])


def test_espnet_ensemble_operations_per_crop():
    _, cfg, _ = harness.resolve("espnet5-glom-dense")
    counted = espnet_ensemble.flops_per_crop(cfg)
    model = ESPNet(cfg["classes"], cfg["p"], cfg["q"]).to("meta")
    x = torch.empty(1, 3, cfg["in_height"], cfg["in_width"], device="meta")
    assert counted == hooked_flops(model, x) * 5
    assert round(counted / 1e9, 2) == 36.34


def test_segformer_b4_operations_per_crop():
    _, cfg, _ = harness.resolve("segformer-b4-glom-dense")
    counted = segformer.flops_per_crop(cfg)
    s = cfg["input_size"]
    model = Segformer(cfg).to("meta")
    layers = hooked_flops(model, torch.empty(1, 3, s, s, device="meta"))
    attention, side = 0.0, s
    for i, width in enumerate(cfg["hidden_sizes"]):
        side //= cfg["strides"][i]
        tokens = side * side
        keys = tokens // cfg["sr_ratios"][i] ** 2
        # q.k^T and attn.v, over all heads: 2 * 2 * T * Tk * width each
        attention += cfg["depths"][i] * 4 * tokens * keys * width
    assert counted == layers + attention
    assert round(counted / 1e9, 1) == 187.5
