"""The port's padded-layout ESP block (K2's plain version on the CPU) and its
layout helpers, against the JAX package's strip-DMA Pallas kernel
(``_esp_dma_call``) in interpret mode."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from glomeruli_segmentation_tpu.convert.espnet_import import _export_esp
from glomeruli_segmentation_tpu.models.espnet import ESPBlock
from glomeruli_segmentation_tpu.ops.pallas import esp_block as jax_esp
from glomeruli_segmentation_tpu_torch.ops import _build
from glomeruli_segmentation_tpu_torch.ops import esp_block as torch_esp


def _block(c, h, w, seed=1):
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
    ops = [torch.from_numpy(a) for a in
           torch_esp.pack_esp_weights(entries, "")]
    return x, jax_esp.pack_esp_weights(params, stats), ops


def _assert_zero_padding(y: torch.Tensor, c: int) -> None:
    halo = torch_esp.HALO
    assert (y[:, :, :halo] == 0).all() and (y[:, :, -halo:] == 0).all()
    assert (y[..., c:] == 0).all()


@pytest.mark.parametrize("c,h,w,add_residual", [
    (64, 16, 32, True),    # level-2 channels of one fold (n=12, n1=16)
    (64, 16, 32, False),
    (320, 32, 128, True),  # the packed channel count, padded to 384
])
def test_esp_block_padded_matches_pallas(c, h, w, add_residual):
    x, jax_ops, ops = _block(c, h, w)
    xp = jax_esp.esp_pad_io(jnp.asarray(x))
    want = np.asarray(jax_esp._esp_dma_call(
        xp, *jax_ops, add_residual=add_residual, interpret=True,
        pack_taps=False))
    before = torch_esp.esp_block_padded.launches
    got = torch_esp.esp_block_padded(torch.from_numpy(np.array(xp)), *ops,
                                     add_residual=add_residual)
    # a CPU tensor takes the plain version: no kernel launch is counted
    assert torch_esp.esp_block_padded.launches == before
    assert tuple(got.shape) == want.shape == (2, h, w + 32,
                                              -(-c // 128) * 128)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=1e-4)
    _assert_zero_padding(got, c)


def test_esp_block_padded_rounds_like_pallas_bf16():
    """bf16: the reduce is rounded to bf16, as the TPU kernel's ``rpad``
    scratch (x's type) rounds it, and the output is cast to bf16."""
    x, jax_ops, ops = _block(64, 16, 32, seed=4)
    xp = jax_esp.esp_pad_io(jnp.asarray(x, jnp.bfloat16))
    want = np.asarray(jax_esp._esp_dma_call(
        xp, jax_ops[0].astype(jnp.bfloat16), jax_ops[1].astype(jnp.bfloat16),
        *jax_ops[2:], add_residual=True, interpret=True, pack_taps=False)
        .astype(jnp.float32))
    got = torch_esp.esp_block_padded(
        torch.from_numpy(np.array(xp.astype(jnp.float32))).bfloat16(),
        ops[0].bfloat16(), ops[1].bfloat16(), *ops[2:])
    assert got.dtype == torch.bfloat16
    # one bf16 rounding of the output (2^-8 relative) plus sums in another
    # order before the bf16-rounded reduce
    np.testing.assert_allclose(got.float().numpy(), want, atol=2e-2,
                               rtol=2e-2)
    _assert_zero_padding(got, 64)


@pytest.mark.parametrize("c", [64, 128, 320])
def test_pad_unpad_round_trip_matches_jax(c):
    x = np.random.RandomState(c).randn(2, 8, 24, c).astype(np.float32)
    got = torch_esp.esp_pad_io(torch.from_numpy(x))
    want = np.asarray(jax_esp.esp_pad_io(jnp.asarray(x)))
    np.testing.assert_array_equal(got.numpy(), want)
    back = torch_esp.esp_unpad_io(got, c)
    np.testing.assert_array_equal(back.numpy(), x)
    np.testing.assert_array_equal(
        back.numpy(), np.asarray(jax_esp.esp_unpad_io(jnp.asarray(want), c)))


def test_chain_on_the_padded_layout_equals_plain_blocks():
    """Two blocks chained on the padded layout (pad once, unpad once) equal
    two unpadded ``esp_block_plain`` calls: the zero halos and pad channels
    each block writes are what the next one needs."""
    x, _, ops1 = _block(64, 16, 40, seed=2)
    _, _, ops2 = _block(64, 16, 40, seed=3)
    xt = torch.from_numpy(x)
    h = torch_esp.esp_pad_io(xt)
    for ops in (ops1, ops2):
        h = torch_esp.esp_block_padded(h, *ops)
        _assert_zero_padding(h, 64)
    got = torch_esp.esp_unpad_io(h, 64)
    want = torch_esp.esp_block_plain(torch_esp.esp_block_plain(xt, *ops1),
                                     *ops2)
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    np.testing.assert_array_equal(
        torch_esp.esp_block_fused_dma(xt, *ops1).numpy(),
        torch_esp.esp_block_fused(xt, *ops1).numpy())


@pytest.mark.parametrize("bad", ["c_pad", "width", "w1", "device"])
def test_esp_block_padded_rejects_bad_operands(bad):
    _, _, ops = _block(64, 8, 16)
    xp = torch.zeros(1, 8, 48, 128)
    if bad == "c_pad":
        xp = torch.zeros(1, 8, 48, 96)
    elif bad == "width":
        xp = torch.zeros(1, 8, 32, 128)
    elif bad == "w1":
        ops[0] = ops[0][:32]
    else:
        # only a CPU tensor takes the plain version: no fallback elsewhere
        xp = xp.to("meta")
    with pytest.raises(ValueError):
        torch_esp.esp_block_padded(xp, *ops)


def test_k2_source_is_built_with_the_others():
    assert "esp_block_dma" in _build.SOURCES
    assert (_build.CSRC / "esp_block_dma.cu").is_file()
    path = _build.library_path("esp_block_dma")
    assert path.name.startswith("esp_block_dma-") and path.suffix == ".so"
    assert path != _build.library_path("esp_block")
