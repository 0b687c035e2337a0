"""The port's fused ESP block (plain version on the CPU) and its weight
packing, against the JAX package's Pallas kernel in interpret mode."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from glomeruli_segmentation_tpu.convert.espnet_import import _export_esp
from glomeruli_segmentation_tpu.models.espnet import ESPBlock
from glomeruli_segmentation_tpu.ops.pallas import esp_block as jax_esp
from glomeruli_segmentation_tpu_torch.ops import esp_block as torch_esp


def _block(c, h, w, seed=0):
    """Random Flax ESP block variables (non-trivial BN statistics), its
    ``.pth`` entries, and a seeded (2, h, w, c) input."""
    rng = np.random.RandomState(seed)
    x = rng.randn(2, h, w, c).astype(np.float32)
    variables = ESPBlock(c).init(jax.random.key(seed), jnp.asarray(x))
    stats = jax.tree.map(
        lambda a: np.asarray(rng.uniform(0.5, 2.0, a.shape), np.float32),
        variables["batch_stats"])
    params = jax.tree.map(np.asarray, variables["params"])
    entries = {}
    _export_esp(entries, "", params, stats, False)
    return x, params, stats, entries


def test_fold_bn_matches_jax():
    rng = np.random.RandomState(3)
    args = [rng.uniform(0.1, 2.0, 16).astype(np.float32) for _ in range(4)]
    for a, b in zip(torch_esp.fold_bn(*args), jax_esp.fold_bn(*args)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("c", [128, 64])
def test_pack_esp_weights_matches_jax(c):
    _, params, stats, entries = _block(c, 8, 16)
    want = jax_esp.pack_esp_weights(params, stats)
    got = torch_esp.pack_esp_weights(entries, "")
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.dtype == np.float32 and a.shape == b.shape
        np.testing.assert_array_equal(a, np.asarray(b))


@pytest.mark.parametrize("add_residual", [True, False])
@pytest.mark.parametrize("c,h,w", [
    (128, 16, 32),  # level-3 channels (n=25, n1=28)
    (64, 32, 64),   # level-2 channels (n=12, n1=16)
    (128, 8, 16),   # H < HALO: every d16 tap but the centre is padding
])
def test_esp_block_plain_matches_pallas(c, h, w, add_residual):
    x, params, stats, entries = _block(c, h, w)
    want = np.asarray(jax_esp.esp_block_fused(
        jnp.asarray(x), *jax_esp.pack_esp_weights(params, stats),
        add_residual=add_residual, interpret=True))
    packed = [torch.from_numpy(a) for a in
              torch_esp.pack_esp_weights(entries, "")]
    before = torch_esp.esp_block_fused.launches
    got = torch_esp.esp_block_fused(torch.from_numpy(x), *packed,
                                    add_residual=add_residual)
    # a CPU tensor takes the plain version: no kernel launch is counted
    assert torch_esp.esp_block_fused.launches == before
    assert got.shape == x.shape and got.dtype == torch.float32
    # f32 sums in another order than XLA's: tighter than the JAX package's
    # own bar for its kernel (atol 2e-4, rtol 2e-2)
    np.testing.assert_allclose(got.numpy(), want, atol=5e-5, rtol=1e-4)


def test_esp_block_plain_rounds_reduce_like_pallas_bf16():
    """bf16 operands: the 1x1 reduce is rounded to bf16 before the dilated
    branches, as the Pallas kernel's bf16 scratch rounds it."""
    x, params, stats, entries = _block(128, 8, 16, seed=4)
    jw = jax_esp.pack_esp_weights(params, stats)
    want = np.asarray(jax_esp.esp_block_fused(
        jnp.asarray(x, jnp.bfloat16), jw[0].astype(jnp.bfloat16),
        jw[1].astype(jnp.bfloat16), *jw[2:], interpret=True)
        .astype(jnp.float32))
    w1, wd, scale, bias, alpha = (torch.from_numpy(a) for a in
                                  torch_esp.pack_esp_weights(entries, ""))
    got = torch_esp.esp_block_fused(
        torch.from_numpy(x).bfloat16(), w1.bfloat16(), wd.bfloat16(),
        scale, bias, alpha)
    assert got.dtype == torch.bfloat16
    # one bf16 rounding of the output (2^-8 relative) plus sums in another
    # order before the bf16-rounded reduce
    np.testing.assert_allclose(got.float().numpy(), want, atol=2e-2,
                               rtol=2e-2)


@pytest.mark.parametrize("bad", ["w1", "wd", "scale", "x"])
def test_esp_block_fused_rejects_bad_operands(bad):
    _, _, _, entries = _block(128, 8, 16)
    ops = dict(zip(("w1", "wd", "scale", "bias", "alpha"),
                   (torch.from_numpy(a) for a in
                    torch_esp.pack_esp_weights(entries, ""))))
    ops["x"] = torch.zeros(1, 8, 16, 128)
    if bad == "w1":
        ops["w1"] = ops["w1"][:64]
    elif bad == "wd":
        ops["wd"] = ops["wd"][:4]
    elif bad == "scale":
        ops["scale"] = ops["scale"].double()
    else:
        ops["x"] = ops["x"][0]
    with pytest.raises(ValueError):
        torch_esp.esp_block_fused(ops["x"], ops["w1"], ops["wd"],
                                  ops["scale"], ops["bias"], ops["alpha"])


def test_build_names_library_by_source_and_reports_missing_nvcc(
        tmp_path, monkeypatch):
    """The library's name carries a hash of its source and flags; without
    nvcc the build raises a clear error instead of loading anything."""
    from glomeruli_segmentation_tpu_torch.ops import _build

    path = _build.library_path("esp_block")
    assert path.parent.name == "torch_kernels"
    assert path.name.startswith("esp_block-") and path.suffix == ".so"
    assert _build.library_path("esp_block") == path
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "torch_kernels")
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no-cuda"))
    monkeypatch.delenv("CUDA_PATH", raising=False)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build(["esp_block"])
