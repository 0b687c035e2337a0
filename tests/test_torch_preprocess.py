"""The port's crop preprocessing against the JAX package's functions."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from glomeruli_segmentation_tpu.ops import preprocess as jax_prep
from glomeruli_segmentation_tpu_torch.ops import preprocess as port_prep


@pytest.mark.parametrize("out_h,out_w", [(24, 48), (64, 128)])
def test_resize_bilinear_dynamic_matches_jax(out_h, out_w):
    """Down- and upsampling of ragged crops in one padded batch: the same
    float32 ops in the same order give the same bytes."""
    rng = np.random.RandomState(0)
    padded = rng.randint(0, 256, (3, 40, 56, 3)).astype(np.uint8)
    hs = np.asarray([40, 17, 33], np.int32)
    ws = np.asarray([56, 9, 41], np.int32)
    want = np.asarray(jax.vmap(
        lambda img, h, w: jax_prep.resize_bilinear_dynamic(
            img.astype(jnp.float32), h, w, out_h, out_w))(padded, hs, ws))
    got = port_prep.resize_bilinear_dynamic(
        torch.from_numpy(padded), torch.from_numpy(hs), torch.from_numpy(ws),
        out_h, out_w)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("max_h", [0, 512])
def test_pack_crops_flat_matches_jax(max_h):
    rng = np.random.RandomState(7)
    crops = [rng.randint(0, 255, (h, w, 3)).astype(np.uint8)
             for h, w in [(300, 400), (512, 256), (123, 457)]]
    want = jax_prep.pack_crops_flat(crops, 4, max_w=512, max_h=max_h)
    got = port_prep.pack_crops_flat(crops, 4, max_w=512, max_h=max_h)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    assert port_prep.flat_bytes_needed(crops, 512) == \
        jax_prep.flat_bytes_needed(crops, 512)
    assert port_prep.flat_quantum(4, max_h, 512) == \
        jax_prep.flat_quantum(4, max_h, 512)


def test_pack_crops_flat_of_bgr_views_matches_jax():
    """The slide loop packs the channel-reversed (BGR) views of RGB reads;
    the port copies those one channel at a time, to the same bytes."""
    rng = np.random.RandomState(8)
    crops = [rng.randint(0, 255, (h, w, 3)).astype(np.uint8)[:, :, ::-1]
             for h, w in [(300, 400), (512, 256), (1, 3), (123, 457)]]
    assert not crops[0].flags.c_contiguous
    want = jax_prep.pack_crops_flat(crops, 5, max_w=512, max_h=512)
    got = port_prep.pack_crops_flat(crops, 5, max_w=512, max_h=512)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("view", ["contiguous", "bgr", "window"])
def test_copy_pixels_is_an_assignment(view):
    rng = np.random.RandomState(9)
    src = rng.randint(0, 255, (40, 70, 3)).astype(np.uint8)
    src = {"contiguous": src, "bgr": src[:, :, ::-1],
           "window": src[5:30, 10:60, ::-1]}[view]
    dst = np.zeros((50, 80, 3), np.uint8)
    want = dst.copy()
    want[: src.shape[0], : src.shape[1]] = src
    port_prep.copy_pixels(dst[: src.shape[0], : src.shape[1]], src)
    np.testing.assert_array_equal(dst, want)


def test_pack_crops_flat_refuses_over_limit(monkeypatch):
    monkeypatch.setattr(port_prep, "FLAT_OFFSET_LIMIT", 1024)
    with pytest.raises(ValueError, match="int32"):
        port_prep.pack_crops_flat(
            [np.zeros((64, 64, 3), np.uint8)], 1, max_w=64, max_h=64)


def test_unflatten_crops_matches_jax():
    """Byte for byte, padding included: rows past a crop's height repeat
    its last row, bytes past its width alias the next row, and a start
    near the buffer end is clamped as dynamic_slice clamps it."""
    rng = np.random.RandomState(5)
    crops = [rng.randint(0, 255, (h, w, 3)).astype(np.uint8)
             for h, w in [(30, 40), (64, 21), (13, 57)]]
    flat, offs, hs, ws = jax_prep.pack_crops_flat(crops, 4, max_w=64,
                                                  bucket_bytes=1 << 12)
    want = np.asarray(jax.jit(jax_prep.unflatten_crops,
                              static_argnums=(4, 5))(
        flat, offs, hs, ws, 64, 64))
    got = port_prep.unflatten_crops(
        torch.from_numpy(flat), torch.from_numpy(offs), torch.from_numpy(hs),
        torch.from_numpy(ws), 64, 64)
    assert got.dtype == torch.uint8 and got.shape == (4, 64, 64, 3)
    np.testing.assert_array_equal(got.numpy(), want)
    # a buffer without slack: the last crop's rows are clamped
    short = flat[: offs[2] + crops[2].size]
    want = np.asarray(jax_prep.unflatten_crops(short, offs, hs, ws, 64, 64))
    got = port_prep.unflatten_crops(
        torch.from_numpy(short), torch.from_numpy(offs), torch.from_numpy(hs),
        torch.from_numpy(ws), 64, 64)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("out_h,out_w", [(300, 400), (37, 129), (512, 1024),
                                         (1200, 700)])
def test_postprocess_nearest_host_matches_jax(out_h, out_w):
    cmap = np.random.RandomState(2).randint(0, 5, (512, 1024)).astype(
        np.uint8)
    np.testing.assert_array_equal(
        port_prep.postprocess_nearest_host(cmap, out_h, out_w),
        jax_prep.postprocess_nearest_host(cmap, out_h, out_w))
