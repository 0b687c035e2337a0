"""The port's fold-packed ensemble (``engine="packed"``) against the JAX
package's ``PackedEnsembleESPNet`` and ``EnsembleSegmenter(engine="packed")``
(Pallas in interpret mode), in f32/highest, with two folds so that a wrong
channel permutation cannot hide, and p=2 so that K2's plain version chains
on the padded layout."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from glomeruli_segmentation_tpu.convert.espnet_import import (
    load_espnet_variables,
)
from glomeruli_segmentation_tpu.models import espnet_packed as jax_packed
from glomeruli_segmentation_tpu.pipeline import fused as jax_fused
from glomeruli_segmentation_tpu.wsi.synthetic import (
    pas_like_image,
    write_pyramidal_tiff,
)
from glomeruli_segmentation_tpu.wsi.tiff_reader import Slide
from glomeruli_segmentation_tpu_torch.convert.espnet_import import (
    random_state_dict,
)
from glomeruli_segmentation_tpu_torch.models import espnet_packed as packed
from glomeruli_segmentation_tpu_torch.ops import esp_block as torch_esp
from glomeruli_segmentation_tpu_torch.pipeline import fused as port_fused

FOLDS = (1, 2)
SMALL = dict(folds=FOLDS, p=2, q=2, in_height=64, in_width=128,
             batch_size=2, compute_dtype="float32", precision="highest")
MEANS = [port_fused.FOLD_NORMALIZATION[f][0] for f in FOLDS]
STDS = [port_fused.FOLD_NORMALIZATION[f][1] for f in FOLDS]
PERMS = ("perm95", "perm320", "perm640", "perm655", "pos640", "perm50",
         "perm120")
# ragged boxes, one overhanging the slide's bottom edge and one past it
DETECTIONS = [[256, 256, 480, 470, 0.9], [640, 384, 861, 563, 0.9],
              [100, 700, 330, 930, 0.9], [900, 880, 1100, 1100, 0.9],
              [300, 1050, 420, 1160, 0.9]]


@pytest.fixture(scope="module")
def checkpoints(tmp_path_factory):
    """Two fold checkpoints with calibrated BN statistics."""
    d = tmp_path_factory.mktemp("packed_folds")
    paths = []
    for fold in FOLDS:
        path = d / f"espnet_fold{fold}.pth"
        torch.save(random_state_dict(fold, 5, p=2, q=2), path)
        paths.append(str(path))
    return paths


def _models(checkpoints, fuse_level2: bool):
    """The port's packed model (CPU, f32) and the JAX one (interpret), with
    level 3 through K1 / the Pallas kernel and level 2 as asked."""
    port = packed.PackedEnsembleESPNet(
        [torch.load(p, weights_only=True) for p in checkpoints], MEANS, STDS,
        fuse_level3=True, fuse_level2=fuse_level2, dtype=torch.float32,
        device="cpu")
    ref = jax_packed.PackedEnsembleESPNet(
        [load_espnet_variables(p) for p in checkpoints], MEANS, STDS,
        classes=5, p=2, q=2, level3="pallas",
        level2="pallas" if fuse_level2 else "xla", interpret=True,
        compute_dtype="float32", precision="highest")
    return port, ref


@pytest.fixture(scope="module")
def models(checkpoints):
    return {level2: _models(checkpoints, level2) for level2 in (False, True)}


def _crops(seed=5, n=2):
    img, _ = pas_like_image(64, 128, seed=seed, n_glomeruli=2)
    rng = np.random.RandomState(seed)
    crops = np.stack([img[..., ::-1]] * n).astype(np.float32)
    crops[1:, :, :48] = rng.uniform(0, 255, (n - 1, 64, 48, 3))
    return crops


def test_permutations_match_jax(models):
    port, ref = models[False]
    for name in PERMS:
        np.testing.assert_array_equal(getattr(port, name),
                                      np.asarray(getattr(ref, name)))
    # two folds: the part-major layouts are not the identity
    assert (port.perm320 != np.arange(port.perm320.size)).any()


def test_block_diag_matches_jax():
    rng = np.random.RandomState(0)
    kernels = [rng.randn(6, 4, 3, 3).astype(np.float32) for _ in range(3)]
    want = jax_packed._block_diag([k.transpose(2, 3, 1, 0) for k in kernels])
    got = packed._block_diag(kernels)
    np.testing.assert_array_equal(got.transpose(2, 3, 1, 0), want)
    # transposed-conv kernels (I, O, 2, 2) are block-diagonal over I and O
    ups = [rng.randn(5, 3, 2, 2).astype(np.float32) for _ in range(2)]
    want = jax_packed._block_diag([k.transpose(2, 3, 0, 1) for k in ups])
    np.testing.assert_array_equal(
        packed._block_diag(ups).transpose(2, 3, 0, 1), want)


def test_level2_kernel_operands_match_jax(models):
    port, ref = models[True]
    # only the selected level-2 form is packed, and per fold only the
    # level 3, b3 and classifier are kept
    assert "level2" not in port.enc
    assert len(models[False][0].enc["level2"]) == 2
    assert not hasattr(models[False][0], "level2_kernel")
    assert len(port.heads) == len(FOLDS)
    assert len(port.level2_kernel) == 2
    for i, ops in enumerate(port.level2_kernel):
        for got, want in zip(ops, ref.level2_kernel):
            assert got.dtype == torch.float32
            np.testing.assert_array_equal(got.numpy(), np.asarray(want[i]))


@pytest.mark.parametrize("fuse_level2", [False, True])
def test_packed_logits_match_jax(models, fuse_level2):
    port, ref = models[fuse_level2]
    crops = _crops()
    want = np.asarray(ref.packed_logits(jnp.asarray(crops)))
    before = torch_esp.esp_block_padded.launches
    got = port.packed_logits(torch.from_numpy(crops))
    # CPU tensors take the plain versions: no kernel launch is counted
    assert torch_esp.esp_block_padded.launches == before
    assert tuple(got.shape) == want.shape == (2, 64, 128, 2, 5)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=1e-4)
    maps = port(torch.from_numpy(crops)).numpy()
    assert maps.dtype == np.uint8 and len(np.unique(maps)) > 1
    np.testing.assert_array_equal(maps, np.asarray(ref(jnp.asarray(crops))))


@pytest.mark.parametrize("fuse_level2", [False, True])
def test_gathered_argmax_matches_jax(models, fuse_level2):
    port, ref = models[fuse_level2]
    crops = _crops(seed=8)
    ys = np.stack([np.arange(12) * 5, np.arange(12) * 3 + 1]).astype(np.int32)
    xs = np.stack([np.arange(20) * 6 + 1, np.arange(20) * 2]).astype(np.int32)
    want = np.asarray(ref.gathered_argmax(jnp.asarray(crops),
                                          jnp.asarray(ys), jnp.asarray(xs)))
    got = port.gathered_argmax(torch.from_numpy(crops), torch.from_numpy(ys),
                               torch.from_numpy(xs)).numpy()
    assert got.shape == (2, 12, 20) and got.dtype == np.uint8
    np.testing.assert_array_equal(got, want)
    # the gather commutes with the classifier upconv
    full = port(torch.from_numpy(crops)).numpy()
    np.testing.assert_array_equal(
        got, full[np.arange(2)[:, None, None], ys[:, :, None],
                  xs[:, None, :]])


# ---------------- through EnsembleSegmenter(engine="packed") ----------------
@pytest.fixture(scope="module")
def port(checkpoints):
    return port_fused.EnsembleSegmenter(
        port_fused.EnsembleConfig(checkpoints=checkpoints, **SMALL),
        engine="packed", device="cpu")


@pytest.fixture(scope="module")
def jax_ensemble(checkpoints):
    return jax_fused.EnsembleSegmenter(
        jax_fused.EnsembleConfig(checkpoints=checkpoints, **SMALL),
        engine="packed")


def _batch():
    rng = np.random.RandomState(0)
    img, _ = pas_like_image(96, 160, seed=3, n_glomeruli=2)
    padded = np.stack([img, img[::-1]])[..., ::-1].copy()  # BGR
    padded[1, :, :40] = rng.randint(0, 255, (96, 40, 3))
    hs = np.asarray([96, 71], np.int32)
    ws = np.asarray([160, 133], np.int32)
    return padded, hs, ws


def test_segment_batch_padded_matches_jax(port, jax_ensemble):
    assert port.engine == "packed" and port.nets is None
    assert port._packed.fuse_level3 and not port._packed.fuse_level2
    padded, hs, ws = _batch()
    want = jax_ensemble.segment_batch_padded(padded, hs, ws)
    got = port.segment_batch_padded(padded, hs, ws)
    assert got.dtype == np.uint8 and got.shape == (2, 64, 128)
    assert len(np.unique(want)) > 1
    np.testing.assert_array_equal(got, want)


def test_segment_batch_gather_matches_jax(port, jax_ensemble):
    padded, hs, ws = _batch()
    ys = np.stack([np.arange(12) * 5, np.arange(12) * 3]).astype(np.int32)
    xs = np.stack([np.arange(20) * 6, np.arange(20) * 2]).astype(np.int32)
    want = jax_ensemble.segment_batch_gather(padded, hs, ws, ys, xs)
    got = port.segment_batch_gather(padded, hs, ws, ys, xs)
    assert got.shape == (2, 12, 20)
    np.testing.assert_array_equal(got, want)


@pytest.fixture(scope="module")
def slide(tmp_path_factory):
    img, _ = pas_like_image(1024, 1536, seed=21, n_glomeruli=4)
    path = str(tmp_path_factory.mktemp("packed_slide") / "s.tiff")
    write_pyramidal_tiff(path, img, mpp=0.25, levels=3)
    return Slide(path)


@pytest.fixture(scope="module")
def jax_canvas(jax_ensemble, slide):
    seg = jax_fused.FusedSlideSegmenter(jax_ensemble, transfer="padded")
    return seg.segment_slide(slide, DETECTIONS)


@pytest.mark.parametrize("transfer", ["flat", "padded"])
def test_segment_slide_matches_jax(port, slide, jax_canvas, transfer):
    seg = port_fused.FusedSlideSegmenter(port, transfer=transfer)
    canvas = seg.segment_slide(slide, DETECTIONS)
    assert canvas.shape == (1024 // 8, 1536 // 8) and canvas.max() > 0
    np.testing.assert_array_equal(canvas, jax_canvas)


def test_packed_and_fused_engines_agree(checkpoints, port):
    fused = port_fused.EnsembleSegmenter(
        port_fused.EnsembleConfig(checkpoints=checkpoints, **SMALL),
        engine="fused", device="cpu")
    padded, hs, ws = _batch()
    np.testing.assert_array_equal(port.segment_batch_padded(padded, hs, ws),
                                  fused.segment_batch_padded(padded, hs, ws))


def test_packed_level2_through_k2_plain_matches_plain_level2(checkpoints,
                                                             port):
    k2 = port_fused.EnsembleSegmenter(
        port_fused.EnsembleConfig(checkpoints=checkpoints, **SMALL),
        engine="packed", device="cpu", fuse_level2=True)
    padded, hs, ws = _batch()
    np.testing.assert_array_equal(k2.segment_batch_padded(padded, hs, ws),
                                  port.segment_batch_padded(padded, hs, ws))


@pytest.mark.parametrize("batch,engine", [(8, "packed"), (128, "fused")])
def test_auto_engine_resolution(checkpoints, batch, engine):
    cfg = port_fused.EnsembleConfig(checkpoints=checkpoints,
                                    **{**SMALL, "batch_size": batch})
    ens = port_fused.EnsembleSegmenter(cfg, engine="auto", device="cpu")
    assert ens.engine == engine
    assert ens.fuse_level3 == (batch < 96)


def test_fuse_level2_needs_the_packed_engine(checkpoints):
    cfg = port_fused.EnsembleConfig(checkpoints=checkpoints, **SMALL)
    with pytest.raises(ValueError, match="packed engine only"):
        port_fused.EnsembleSegmenter(cfg, engine="fused", device="cpu",
                                     fuse_level2=True)


def test_packed_model_defaults_to_cuda(checkpoints):
    """Without ``device=`` the packed model runs on the card; with no card
    it raises instead of falling back to the CPU."""
    sds = [torch.load(p, weights_only=True) for p in checkpoints]
    if torch.cuda.is_available():
        assert packed.PackedEnsembleESPNet(sds, MEANS, STDS).device.type \
            == "cuda"
        return
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        packed.PackedEnsembleESPNet(sds, MEANS, STDS)
