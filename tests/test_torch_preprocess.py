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


def test_pack_crops_flat_into_a_torch_buffer_matches_jax(monkeypatch):
    """With ``pin_memory`` the crops are written into a torch buffer from
    ``torch.empty(..., pin_memory=True)`` (here a CPU buffer full of 7s,
    as a reused block would hold old bytes), and that tensor is what comes
    back: its bytes are the JAX package's, the zeroed tail included."""
    real_empty = torch.empty
    made = []

    def empty(*size, pin_memory=False, **kw):
        assert pin_memory
        t = real_empty(*size, **kw).fill_(7)
        made.append(t)
        return t

    rng = np.random.RandomState(10)
    crops = [rng.randint(0, 255, (h, w, 3)).astype(np.uint8)[:, :, ::-1]
             for h, w in [(300, 400), (512, 256), (1, 3), (123, 457)]]
    want = jax_prep.pack_crops_flat(crops, 5, max_w=512, max_h=512)
    monkeypatch.setattr(port_prep.torch, "empty", empty)
    got = port_prep.pack_crops_flat(crops, 5, max_w=512, max_h=512,
                                    pin_memory=True)
    (buf,) = made
    assert isinstance(got[0], torch.Tensor) and got[0] is buf
    assert buf.dtype == torch.uint8 and buf.shape == want[0].shape
    content = sum(c.size for c in crops)
    assert content < len(want[0]) and not want[0][content:].any()
    np.testing.assert_array_equal(buf.numpy(), want[0])
    for a, b in zip(got[1:], want[1:]):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def _cv2_allocates(monkeypatch):
    """cv2's channel swap handing back a new array instead of writing into
    its ``dst``, as cv2 does where it cannot use the array given."""
    import cv2

    monkeypatch.setattr(
        cv2, "cvtColor",
        lambda src, code, dst=None: np.ascontiguousarray(src[:, :, ::-1]))


@pytest.mark.parametrize("view", [
    "contiguous", "bgr", "window",
    # the flat layout's destination: one run of bytes
    "bgr_into_flat",
    # a slot of the padded layout: rows max_w pixels apart
    "bgr_into_padded_slot",
    "one_pixel",
    # a window of a read, so its rows are strided, into the flat layout
    "strided_rows_into_flat",
    # a destination cv2 cannot write in place: its channels reversed
    "dst_channels_reversed",
    # cv2 returns a new array: the copy falls back to three passes
    "cv2_allocates"])
def test_copy_pixels_is_an_assignment(view, monkeypatch):
    rng = np.random.RandomState(9)
    src = rng.randint(0, 255, (40, 70, 3)).astype(np.uint8)
    src = {"contiguous": src, "window": src[5:30, 10:60, ::-1],
           "one_pixel": src[3:4, 7:8, ::-1],
           "strided_rows_into_flat": src[5:30, 10:60, ::-1]}.get(
               view, src[:, :, ::-1])
    h, w = src.shape[:2]
    # (the array the destination lies in, the destination in it)
    full, place = {
        "bgr_into_flat": ((h * w * 3 + 11,),
                          lambda a: a[4: 4 + h * w * 3].reshape(h, w, 3)),
        "strided_rows_into_flat": (
            (h * w * 3 + 11,),
            lambda a: a[4: 4 + h * w * 3].reshape(h, w, 3)),
        "bgr_into_padded_slot": ((3, 64, 96, 3), lambda a: a[1, :h, :w]),
        "dst_channels_reversed": ((50, 80, 3), lambda a: a[:h, :w, ::-1]),
    }.get(view, ((50, 80, 3), lambda a: a[:h, :w]))
    full = np.zeros(full, np.uint8)
    want = full.copy()
    place(want)[...] = src
    if view == "cv2_allocates":
        _cv2_allocates(monkeypatch)
    port_prep.copy_pixels(place(full), src)
    np.testing.assert_array_equal(full, want)


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
