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


def _one_group(ops):
    """A block's operands as K2 takes them: one group."""
    return [*torch_esp.pack_esp_groups(ops[0], ops[1], 1), *ops[2:]]


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
    got = torch_esp.esp_block_padded(torch.from_numpy(np.array(xp)),
                                     *_one_group(ops),
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
    w1, wd = torch_esp.pack_esp_groups(ops[0], ops[1], 1)
    got = torch_esp.esp_block_padded(
        torch.from_numpy(np.array(xp.astype(jnp.float32))).bfloat16(),
        w1.bfloat16(), wd.bfloat16(), *ops[2:])
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
        h = torch_esp.esp_block_padded(h, *_one_group(ops))
        _assert_zero_padding(h, 64)
    got = torch_esp.esp_unpad_io(h, 64)
    want = torch_esp.esp_block_plain(torch_esp.esp_block_plain(xt, *ops1),
                                     *ops2)
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    np.testing.assert_array_equal(
        torch_esp.esp_block_fused_dma(xt, *ops1).numpy(),
        torch_esp.esp_block_fused(xt, *ops1).numpy())


@pytest.mark.parametrize("bad", ["c_pad", "width", "w1", "device",
                                 "dense"])
def test_esp_block_padded_rejects_bad_operands(bad):
    _, _, dense = _block(64, 8, 16)
    ops = _one_group(dense)
    xp = torch.zeros(1, 8, 48, 128)
    if bad == "c_pad":
        xp = torch.zeros(1, 8, 48, 96)
    elif bad == "width":
        xp = torch.zeros(1, 8, 32, 128)
    elif bad == "w1":
        ops[0] = ops[0][:, :32]
    elif bad == "dense":
        # K2 takes grouped operands only (pack_esp_groups)
        ops = dense
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


# ---------------- K2's per-fold (grouped) operands ----------------
@pytest.fixture(scope="module", params=[2, 5], ids=["2folds", "5folds"])
def packed_level2(request):
    """(folds, the packed model, its level-2 blocks' dense operands) from
    real packed level-2 blocks: ``random_state_dict`` folds, f32, on the
    CPU.  The dense operands are built here from the folds' own packs, as
    the model builds them before it cuts them into K2's per-fold ones."""
    from glomeruli_segmentation_tpu_torch.convert.espnet_import import (
        random_state_dict,
    )
    from glomeruli_segmentation_tpu_torch.models.espnet_fused import (
        FusedESPNet,
    )
    from glomeruli_segmentation_tpu_torch.models.espnet_packed import (
        PackedEnsembleESPNet,
        _esp_fused_operands,
    )
    from glomeruli_segmentation_tpu_torch.pipeline.fused import (
        FOLD_NORMALIZATION,
    )

    folds = request.param
    norm = [FOLD_NORMALIZATION[f] for f in range(1, folds + 1)]
    state_dicts = [random_state_dict(f, 5, p=2, q=2)
                   for f in range(1, folds + 1)]
    model = PackedEnsembleESPNet(
        state_dicts, [m for m, _ in norm], [s for _, s in norm],
        fuse_level2=True, dtype=torch.float32, device="cpu")
    nets = [FusedESPNet(sd, dtype=torch.float32, device="cpu")
            for sd in state_dicts]
    dense = [tuple(torch.from_numpy(a) for a in _esp_fused_operands(
        PackedEnsembleESPNet._host_pack([net.enc["level2"][i] for net in nets],
                                        model.perm320, model.perm320)))
        for i in range(model.p)]
    return folds, model, dense


def test_grouped_packing_round_trips(packed_level2):
    folds, model, dense_ops = packed_level2
    for dense, grouped in zip(dense_ops, model.level2_kernel):
        w1, wd = dense[:2]
        w1g, wdg = torch_esp.pack_esp_groups(w1, wd, folds)
        assert tuple(w1g.shape) == (folds, 64, 12)
        assert tuple(wdg.shape) == (folds, 5, 108, 16)
        back_w1, back_wd = torch_esp.unpack_esp_groups(w1g, wdg)
        assert torch.equal(back_w1, w1) and torch.equal(back_wd, wd)
        # what the model keeps for K2 is this packing, packed once
        assert torch.equal(grouped[0], w1g) and torch.equal(grouped[1], wdg)
        for got, want in zip(grouped[2:], dense[2:]):
            assert torch.equal(got, want)


def test_group_channels_are_the_packed_layout(packed_level2):
    """Fold f's local channel c sits where the packed engine puts fold f's
    semantic channel c of level 2 (the inverse of ``perm320``)."""
    from glomeruli_segmentation_tpu_torch.models.espnet_packed import (
        _pos_of_sem,
    )

    folds, model, _ = packed_level2
    want = _pos_of_sem(model.perm320).reshape(folds, 64)
    np.testing.assert_array_equal(
        torch_esp.esp_group_channels(64 * folds, 12 * folds, folds), want)


def test_grouped_plain_equals_dense_plain_and_pallas(packed_level2):
    """Per-fold plain blocks placed into the part-major channels equal the
    dense block-diagonal block, and the JAX strip-DMA kernel (interpret)."""
    folds, model, dense_ops = packed_level2
    dense = dense_ops[1]
    w1g, wdg, scale, bias, alpha = model.level2_kernel[1]
    c = 64 * folds
    x = torch.from_numpy(
        np.random.RandomState(folds).randn(2, 12, 40, c).astype(np.float32))
    chans = torch.from_numpy(torch_esp.esp_group_channels(c, 12 * folds,
                                                          folds))
    per_fold = torch.empty_like(x)
    for f in range(folds):
        per_fold[..., chans[f]] = torch_esp.esp_block_plain(
            x[..., chans[f]], w1g[f], wdg[f], scale[chans[f]],
            bias[chans[f]], alpha[chans[f]])
    xp = torch_esp.esp_pad_io(x)
    want = torch_esp.esp_block_padded_plain(xp, *dense)
    got = torch_esp.esp_pad_io(per_fold)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-6,
                               rtol=1e-6)
    # the wrapper on a CPU tensor, given the per-fold operands
    np.testing.assert_array_equal(
        torch_esp.esp_block_padded(xp, w1g, wdg, scale, bias, alpha).numpy(),
        want.numpy())
    pallas = np.asarray(jax_esp._esp_dma_call(
        jnp.asarray(xp.numpy()), *(jnp.asarray(t.numpy()) for t in dense),
        add_residual=True, interpret=True, pack_taps=False))
    np.testing.assert_allclose(got.numpy(), pallas, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("where", ["w1", "wd", "wd_d1"])
def test_pack_refuses_a_cross_fold_entry(packed_level2, where):
    folds, _, dense_ops = packed_level2
    w1, wd = (t.clone() for t in dense_ops[0][:2])
    n = w1.shape[1]
    if where == "w1":
        w1[0, n - 1] = 1e-3  # fold 0's channel 0 into the last fold's r
    elif where == "wd":
        # tap 4, fold 0's r channel 0, into the last fold's add1 column
        wd[1, 4 * n, n - 1] = 1e-3
    else:
        # the d1 branch: the last fold's r channel into fold 0's d1 column
        wd[0, 4 * n + n - 1, 0] = 1e-3
    with pytest.raises(ValueError, match="diagonal blocks"):
        torch_esp.pack_esp_groups(w1, wd, folds)


def test_pack_refuses_widths_that_do_not_split():
    w1 = torch.zeros(320, 60)
    wd = torch.zeros(5, 540, 80)
    with pytest.raises(ValueError, match="split"):
        torch_esp.pack_esp_groups(w1, wd, 3)


def test_library_path_covers_the_headers(tmp_path, monkeypatch):
    """An edited header under csrc/ rebuilds every source (the hash of each
    library covers the headers)."""
    for src in _build.CSRC.iterdir():
        if src.suffix in (".cu", ".cuh"):
            (tmp_path / src.name).write_bytes(src.read_bytes())
    assert (tmp_path / "mma_bf16.cuh").is_file()
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    before = {name: _build.library_path(name) for name in _build.SOURCES}
    header = tmp_path / "mma_bf16.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    after = {name: _build.library_path(name) for name in _build.SOURCES}
    assert all(before[name] != after[name] for name in _build.SOURCES)
