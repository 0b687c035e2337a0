"""The port's ``xla`` fold ensemble engine, the packed class-map readback,
the resized forwards and the host-resize slide path against the JAX
package's on the CPU, in f32/highest, at p=2 q=2, 64x128, three folds."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from glomeruli_segmentation_tpu.convert.espnet_import import (
    state_dict_to_variables,
)
from glomeruli_segmentation_tpu.models.espnet import ESPNet as JaxESPNet
from glomeruli_segmentation_tpu.ops import preprocess as jax_preprocess
from glomeruli_segmentation_tpu.pipeline import e2e as jax_e2e
from glomeruli_segmentation_tpu.pipeline import fused as jax_fused
from glomeruli_segmentation_tpu.wsi.synthetic import pas_like_image
from glomeruli_segmentation_tpu_torch import read_host
from glomeruli_segmentation_tpu_torch.convert.espnet_import import (
    random_state_dict,
)
from glomeruli_segmentation_tpu_torch.parallel.fold_parallel import (
    stack_states,
)
from glomeruli_segmentation_tpu_torch.pipeline import e2e as port_e2e
from glomeruli_segmentation_tpu_torch.pipeline import fused as port_fused

from test_torch_e2e import (GEOMETRY, StubBackend, assert_same_artifacts,
                            run_both, write_slide)
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

FOLDS = (1, 2, 3)
SMALL = dict(folds=FOLDS, p=2, q=2, in_height=64, in_width=128,
             batch_size=4, compute_dtype="float32", precision="highest")


@pytest.fixture(scope="module")
def states():
    """Three folds' weights with calibrated BN statistics, so the fold
    softmaxes are far from uniform and no argmax is a near-tie."""
    return [random_state_dict(10 + f, 5, p=2, q=2) for f in FOLDS]


@pytest.fixture(scope="module")
def checkpoints(states, tmp_path_factory):
    d = tmp_path_factory.mktemp("xla_folds")
    paths = []
    for fold, sd in zip(FOLDS, states):
        torch.save(sd, d / f"espnet_fold{fold}.pth")
        paths.append(str(d / f"espnet_fold{fold}.pth"))
    return paths


def _port(checkpoints, engine="xla", **change):
    return port_fused.EnsembleSegmenter(
        port_fused.EnsembleConfig(checkpoints=checkpoints,
                                  **{**SMALL, **change}),
        engine=engine, device="cpu")


def _jax(checkpoints, engine="xla", **change):
    return jax_fused.EnsembleSegmenter(
        jax_fused.EnsembleConfig(checkpoints=checkpoints,
                                 **{**SMALL, **change}), engine=engine)


@pytest.fixture(scope="module")
def ensembles(checkpoints):
    """(port, JAX) xla engines on the same checkpoints."""
    return _port(checkpoints), _jax(checkpoints)


def _batch():
    """Four ragged PAS-like crops padded to 96x160, with their sizes."""
    rng = np.random.RandomState(0)
    padded = np.zeros((4, 96, 160, 3), np.uint8)
    hs = np.array([96, 80, 64, 90], np.int32)
    ws = np.array([160, 150, 120, 100], np.int32)
    for i in range(4):
        img, _ = pas_like_image(int(hs[i]), int(ws[i]), seed=5 + i,
                                n_glomeruli=1)
        padded[i, : hs[i], : ws[i]] = img[:, :, ::-1]
    ys = rng.randint(0, 64, (4, 12)).astype(np.int32)
    xs = rng.randint(0, 128, (4, 20)).astype(np.int32)
    return padded, hs, ws, ys, xs


def test_default_engine_is_xla_and_auto_resolves_as_jax(checkpoints, states):
    port = port_fused.EnsembleSegmenter(
        port_fused.EnsembleConfig(checkpoints=checkpoints, **SMALL),
        device="cpu")
    assert port.engine == "xla" and not port.fuse_level3
    assert next(port.nets[0].parameters()).dtype == torch.float32
    assert _port(checkpoints, "auto").engine == "packed"
    assert _port(checkpoints, "auto", batch_size=96).engine == "fused"
    stacked = stack_states(states)
    injected = port_fused.EnsembleSegmenter(
        port_fused.EnsembleConfig(checkpoints=[], **SMALL), engine="auto",
        device="cpu", variables=stacked)
    assert injected.engine == "xla"
    for engine in ("packed", "fused"):
        with pytest.raises(ValueError, match="injected variables"):
            port_fused.EnsembleSegmenter(
                port_fused.EnsembleConfig(checkpoints=checkpoints, **SMALL),
                engine=engine, device="cpu", variables=stacked)


def test_xla_class_maps_equal_jax(ensembles):
    """Padded, /8-gather and flat forwards: the class maps equal the JAX
    xla engine's (the mean of the fold softmaxes, first class on ties)."""
    port, jax_ens = ensembles
    padded, hs, ws, ys, xs = _batch()
    want = jax_ens.segment_batch_padded(padded, hs, ws)
    got = port.segment_batch_padded(padded, hs, ws)
    np.testing.assert_array_equal(got, want)
    assert len(np.unique(got)) >= 3
    np.testing.assert_array_equal(
        port.segment_batch_gather(padded, hs, ws, ys, xs),
        jax_ens.segment_batch_gather(padded, hs, ws, ys, xs))
    crops = [padded[i, : hs[i], : ws[i]] for i in range(4)]
    flat, offs, fh, fw = port_fused.pack_crops_flat(crops, 4, max_w=256,
                                                    max_h=256)
    np.testing.assert_array_equal(
        port.read_maps(port.submit_batch_flat(flat, offs, fh, fw, 256, 256)),
        np.asarray(jax_ens.submit_batch_flat(flat, offs, fh, fw, 256, 256)))


def test_xla_fold_logits_within_1e5(ensembles, states):
    """Each fold's plain ESPNet on its normalised input: logits within
    1e-5 of the largest logit of the JAX model's (float32 convolutions
    summed in another order; measured 4.4e-5 at logits up to 11.5)."""
    port, _ = ensembles
    rng = np.random.RandomState(3)
    x = rng.uniform(0, 255, (2, 64, 128, 3)).astype(np.float32)
    model = JaxESPNet(5, 2, 2)
    for fold, sd, net in zip(FOLDS, states, port.nets):
        mean, std = (np.asarray(v, np.float32)
                     for v in port_fused.FOLD_NORMALIZATION[fold])
        xn = (x - mean) / std / np.float32(255.0)
        want = np.asarray(jax.jit(model.apply)(
            state_dict_to_variables({k: v.numpy() for k, v in sd.items()}),
            jnp.asarray(xn)))
        with torch.no_grad():
            got = net(torch.from_numpy(xn).permute(0, 3, 1, 2))
        diff = np.abs(got.permute(0, 2, 3, 1).numpy() - want).max()
        assert diff <= 1e-5 * np.abs(want).max(), diff


def test_injected_variables_equal_checkpoints(ensembles, states):
    port, _ = ensembles
    padded, hs, ws, _, _ = _batch()
    injected = port_fused.EnsembleSegmenter(
        port_fused.EnsembleConfig(checkpoints=[], **SMALL), device="cpu",
        variables=stack_states(states))
    np.testing.assert_array_equal(
        injected.segment_batch_padded(padded, hs, ws),
        port.segment_batch_padded(padded, hs, ws))


def test_bf16_xla_engine_tracks_f32_and_jax(checkpoints, ensembles):
    """bf16 goes into the weights; the resized batch is cast once.  Class
    maps agree with the f32 engine's and JAX's bf16 xla engine's on nearly
    every pixel (their rounding points differ)."""
    bf16 = dict(compute_dtype="bfloat16", precision="default")
    port = _port(checkpoints, **bf16)
    assert next(port.nets[0].parameters()).dtype == torch.bfloat16
    padded, hs, ws, _, _ = _batch()
    got = port.segment_batch_padded(padded, hs, ws)
    want = _jax(checkpoints, **bf16).segment_batch_padded(padded, hs, ws)
    f32 = ensembles[0].segment_batch_padded(padded, hs, ws)
    assert (got == want).mean() >= 0.98
    assert (got == f32).mean() >= 0.98


@pytest.mark.parametrize("engine", ["xla", "fused", "packed"])
def test_pack_output_bytes_equal_jax(checkpoints, engine):
    """``pack_output``: the packed readback's bytes equal the JAX
    package's (the whole JAX engine for xla and packed; for fused, whose
    maps the fused-pipeline tests hold to the JAX engine's, its
    ``pack_classmap`` of the maps), and ``read_maps`` unpacks them to the
    unpacked run's maps; the /8 gather is never packed."""
    padded, hs, ws, ys, xs = _batch()
    port = _port(checkpoints, engine, pack_output=True)
    plain = _port(checkpoints, engine)
    handle = port.submit_batch_padded(padded, hs, ws)
    packed = read_host(handle)
    assert packed.shape == (4, 64, 43)
    maps = plain.segment_batch_padded(padded, hs, ws)
    if engine == "fused":
        want = np.asarray(jax_preprocess.pack_classmap(jnp.asarray(maps), 5))
    else:
        want = np.asarray(_jax(checkpoints, engine, pack_output=True)
                          .submit_batch_padded(padded, hs, ws))
    np.testing.assert_array_equal(packed, want)
    np.testing.assert_array_equal(port.read_maps(handle), maps)
    np.testing.assert_array_equal(
        port.segment_batch_gather(padded, hs, ws, ys, xs),
        plain.segment_batch_gather(padded, hs, ws, ys, xs))


@pytest.mark.parametrize("engine", ["xla", "packed"])
def test_resized_forwards_equal_jax(checkpoints, ensembles, engine):
    """``submit_batch_resized`` and ``submit_batch_gather_resized`` on a
    host-resized f32 batch equal the JAX package's."""
    import cv2

    padded, hs, ws, ys, xs = _batch()
    resized = np.stack([cv2.resize(
        padded[i, : hs[i], : ws[i]].astype(np.float32), (128, 64),
        interpolation=cv2.INTER_LINEAR) for i in range(4)])
    port, jax_ens = ((ensembles[0], ensembles[1]) if engine == "xla" else
                     (_port(checkpoints, engine), _jax(checkpoints, engine)))
    got = port.read_maps(port.submit_batch_resized(resized))
    np.testing.assert_array_equal(
        got, np.asarray(jax_ens.submit_batch_resized(resized)))
    np.testing.assert_array_equal(
        port.read_gathered(port.submit_batch_gather_resized(resized, ys,
                                                            xs)),
        np.asarray(jax_ens.submit_batch_gather_resized(resized, ys, xs)))


def test_host_bf16_cast_bytes_equal_ml_dtypes():
    """numpy has no bfloat16: the host batch is cast in torch, which
    rounds to nearest even as ``ml_dtypes`` does for the JAX package."""
    rng = np.random.RandomState(7)
    x = np.concatenate([rng.uniform(0, 255, 4096),
                        rng.uniform(-1e3, 1e3, 4096),
                        # halfway cases, where the rounding rule shows
                        (np.arange(256) + 0.5) * 2.0 ** -7 + 1.0,
                        np.arange(256, dtype=np.float64) + 0.5,
                        ]).astype(np.float32).reshape(2, 16, 272, 1)
    got = port_fused.host_resized(x, torch.bfloat16)
    want = np.asarray(x.astype(jnp.bfloat16))
    np.testing.assert_array_equal(got.view(torch.int16).numpy(),
                                  want.view(np.int16))
    np.testing.assert_array_equal(
        port_fused.host_resized(x, torch.float32).numpy(), x)


def test_transfer_rules_match_jax(ensembles):
    port, jax_ens = ensembles
    for host_resize in (False, True):
        assert port_fused.FusedSlideSegmenter(
            port, host_resize=host_resize).transfer == \
            jax_fused.FusedSlideSegmenter(
                jax_ens, host_resize=host_resize).transfer
    assert port_fused.FusedSlideSegmenter(port).transfer == "flat"
    for cls, ens in ((port_fused.FusedSlideSegmenter, port),
                     (jax_fused.FusedSlideSegmenter, jax_ens)):
        with pytest.raises(ValueError, match="transfer='flat' is "
                                             "single-device"):
            cls(ens, host_resize=True, transfer="flat")


@pytest.fixture(scope="module")
def packed_pair(checkpoints):
    return (_port(checkpoints, "packed", batch_size=2),
            _jax(checkpoints, "packed", batch_size=2))


@pytest.mark.parametrize("crop_artifact", ["labelme", "png"])
def test_host_resize_slide_matches_jax(packed_pair, tmp_path,
                                       crop_artifact):
    """``FusedEndToEnd(host_resize=True)`` with one numpy detector shared
    by both packages, f32 packed engine: the canvas, the merged CSV, every
    per-crop file and the overlay byte-identical to the JAX package's."""
    slide = (write_slide(tmp_path / "H9.tiff", seed=39), "H9")
    kw = dict(GEOMETRY, detect_conf=0.5, merge_conf=0.9, host_resize=True,
              crop_artifact=crop_artifact)
    port_pipe = port_e2e.FusedEndToEnd(StubBackend(), packed_pair[0], **kw)
    jax_pipe = jax_e2e.FusedEndToEnd(StubBackend(), packed_pair[1], **kw)
    assert port_pipe.segmenter.transfer == "padded"
    (pd, pc), (jd, jc) = run_both(port_pipe, jax_pipe, slide, tmp_path)
    np.testing.assert_array_equal(pc, jc)
    assert pc.max() > 0
    assert_same_artifacts(pd, jd, ["H9"])
    # the --no_json path: the /8 maps gathered on the device
    canvases = []
    for ens, cls in ((packed_pair[0], port_fused.FusedSlideSegmenter),
                     (packed_pair[1], jax_fused.FusedSlideSegmenter)):
        from glomeruli_segmentation_tpu.wsi.tiff_reader import Slide

        with Slide(slide[0]) as s:
            boxes = [[40, 40, 300, 260, 0.9], [500, 300, 760, 520, 0.9],
                     [600, 900, 800, 1100, 0.9]]
            canvases.append(cls(ens, host_resize=True).segment_slide(
                s, boxes))
    np.testing.assert_array_equal(canvases[0], canvases[1])


def test_pack_classmap_and_maybe_pack_match_jax():
    """``pack_classmap`` bytes equal the JAX package's at every class count
    and at widths 3 does not divide; the host LUT unpack is exact."""
    from glomeruli_segmentation_tpu_torch.ops import preprocess as port_pre

    rng = np.random.RandomState(1)
    for classes in (1, 2, 3, 5, 6, 16, 17):
        assert port_pre.classmap_pack_width(classes) == \
            jax_preprocess.classmap_pack_width(classes)
        for w in (1, 2, 3, 64, 127, 128, 1022):
            maps = rng.randint(0, max(classes, 1), (2, 5, w)).astype(
                np.uint8)
            got = port_pre.pack_classmap(torch.from_numpy(maps),
                                         classes).numpy()
            want = np.asarray(jax_preprocess.pack_classmap(
                jnp.asarray(maps), classes))
            np.testing.assert_array_equal(got, want)
            np.testing.assert_array_equal(
                port_pre.unpack_classmap(got, classes, w), maps)
            np.testing.assert_array_equal(
                port_pre.read_packed(
                    port_pre.maybe_pack(torch.from_numpy(maps), classes,
                                        True).numpy(), classes, w, True),
                jax_preprocess.read_packed(want, classes, w, True))
    maps = torch.from_numpy(rng.randint(0, 5, (1, 4, 9)).astype(np.uint8))
    assert port_pre.maybe_pack(maps, 5, False) is maps


def test_resize_nearest_matches_jax_and_cv2():
    """``resize_nearest`` equals the JAX package's and cv2 INTER_NEAREST,
    down and up, on class maps and on images."""
    import cv2

    from glomeruli_segmentation_tpu.ops.resize import (
        resize_nearest as jax_resize_nearest,
    )
    from glomeruli_segmentation_tpu_torch.ops.resize import resize_nearest

    rng = np.random.RandomState(4)
    for shape, (out_h, out_w) in (((64, 128), (37, 211)),
                                  ((70, 45, 3), (512, 1024)),
                                  ((512, 1024), (64, 128)),
                                  ((33, 17, 3), (33, 17))):
        img = rng.randint(0, 256, shape).astype(np.uint8)
        got = resize_nearest(torch.from_numpy(img), out_h, out_w).numpy()
        np.testing.assert_array_equal(
            got, np.asarray(jax_resize_nearest(jnp.asarray(img), out_h,
                                               out_w)))
        np.testing.assert_array_equal(got, cv2.resize(
            img, (out_w, out_h), interpolation=cv2.INTER_NEAREST))
