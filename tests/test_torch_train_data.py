"""The port's training data pipeline (``data/transforms.py``,
``data/dataset.py``, ``data/load_data.py``, ``cli/create_dataset_txt.py``
and the SegFormer trainer's ``_PairLoader``) against the JAX package's on
the CPU: every transform byte-identical under one seed, both loaders'
batches byte-identical and in the same order over two epochs (threaded,
with and without prefetch), ``LoadData``'s statistics equal and each
package reading the other's cache, and the dataset lists byte-identical.
``write_espnet_tree`` is shared by the other training test files."""
import pickle

import cv2
import numpy as np
import pytest

from glomeruli_segmentation_tpu.cli import create_dataset_txt as jax_cli
from glomeruli_segmentation_tpu.data import dataset as jax_dataset
from glomeruli_segmentation_tpu.data import load_data as jax_load
from glomeruli_segmentation_tpu.data import transforms as jax_t
from glomeruli_segmentation_tpu.train import segformer_train as jax_seg
from glomeruli_segmentation_tpu_torch.cli import create_dataset_txt as port_cli
from glomeruli_segmentation_tpu_torch.data import dataset as port_dataset
from glomeruli_segmentation_tpu_torch.data import load_data as port_load
from glomeruli_segmentation_tpu_torch.data import transforms as port_t
from glomeruli_segmentation_tpu_torch.data import (
    segformer_dataset as port_segformer_dataset,
)
from glomeruli_segmentation_tpu_torch.train import segformer_train as port_seg
from glomeruli_segmentation_tpu_torch.utils.labelme_io import lblsave

from test_segformer_pipeline import _gtcs_tree


def write_espnet_tree(root, n_train=4, n_val=2, size=(48, 96), seed=0):
    """``root/{train,val}/{rgb,label}/<patient>/<crop>.PNG``: PAS-like BGR
    crops with a few discs of classes 1..4 on background 0 (palette
    labels), in two patients, then ``create_dataset_txt``'s lists."""
    rng = np.random.RandomState(seed)
    h, w = size
    yy, xx = np.mgrid[:h, :w]
    for split, count in (("train", n_train), ("val", n_val)):
        for i in range(count):
            patient = f"P{i % 2}"
            rgb_dir = root / split / "rgb" / patient
            lbl_dir = root / split / "label" / patient
            rgb_dir.mkdir(parents=True, exist_ok=True)
            lbl_dir.mkdir(parents=True, exist_ok=True)
            img = (rng.uniform(190, 225, (h, w, 3))).astype(np.uint8)
            lbl = np.zeros((h, w), np.uint8)
            for c in range(1, 5):
                cy, cx = rng.randint(0, h), rng.randint(0, w)
                disc = (yy - cy) ** 2 + (xx - cx) ** 2 < (h // 5) ** 2
                img[disc] = rng.randint(60, 180, 3)
                lbl[disc] = c
            cv2.imwrite(str(rgb_dir / f"crop{i}.PNG"), img)
            lblsave(str(lbl_dir / f"crop{i}.PNG"), lbl)
    port_load.create_dataset_txt(str(root))
    return root


def _pipelines(t, mean, std):
    """The trainers' augmentation chains (ESPNet's main scale at a small
    size with the encoder's label downsampling; SegFormer's extras)."""
    return [
        t.Compose([t.Normalize(mean, std), t.Scale(64, 32),
                   t.RandomCropResize(8), t.RandomFlip(), t.ToTensor(8)]),
        t.Compose([t.Normalize(mean, std), t.Scale(96, 48),
                   t.RandomFlip(), t.ToTensor(1)]),
        t.Compose([t.RandomCropResize(16), t.RandomFlip(),
                   t.RandomVerticalFlip(), t.RandomBlurringAndSharpning(),
                   t.RandomContrast()]),
    ]


def test_transforms_match_jax():
    """Each chain over 40 seeds: images and labels byte-identical, the
    same dtypes (every branch of every random transform is taken)."""
    rng = np.random.RandomState(0)
    image = rng.randint(0, 256, (50, 90, 3)).astype(np.uint8)
    label = rng.randint(0, 5, (50, 90)).astype(np.uint8)
    mean, std = (200.0, 170.0, 195.0), (20.0, 40.0, 30.0)
    for jax_tf, port_tf in zip(_pipelines(jax_t, mean, std),
                               _pipelines(port_t, mean, std)):
        for seed in range(40):
            want = jax_tf(np.random.default_rng(seed), image.copy(),
                          label.copy())
            got = port_tf(np.random.default_rng(seed), image.copy(),
                          label.copy())
            for a, b in zip(got, want):
                assert a.dtype == b.dtype and a.shape == b.shape
                assert np.array_equal(a, b)


@pytest.mark.parametrize("prefetch", [0, 1])
def test_loaders_match_jax(tmp_path, prefetch):
    """Both packages' threaded loaders give byte-identical batches in the
    same order over two epochs (the epoch-seeded shuffle and per-item
    seeds), the ragged last batch included."""
    write_espnet_tree(tmp_path, n_train=5)
    lines = (tmp_path / "train.txt").read_text().splitlines()
    ims = [ln.split(",")[0] for ln in lines]
    annots = [ln.split(",")[1] for ln in lines]
    mean, std = (200.0, 170.0, 195.0), (20.0, 40.0, 30.0)

    def batches(pkg, t):
        tf = _pipelines(t, mean, std)[0]
        loader = pkg.DataLoader(pkg.SegmentationDataset(ims, annots, tf),
                                2, num_workers=3, seed=7,
                                prefetch=prefetch)
        assert len(loader) == 3
        return [b for _ in range(2) for b in loader]

    want = batches(jax_dataset, jax_t)
    got = batches(port_dataset, port_t)
    assert len(got) == len(want) == 6
    for (gx, gy), (wx, wy) in zip(got, want):
        assert gx.dtype == wx.dtype == np.float32
        assert gy.dtype == wy.dtype == np.int32
        assert np.array_equal(gx, wx) and np.array_equal(gy, wy)
    assert got[0][0].shape == (2, 32, 64, 3) and got[2][0].shape[0] == 1


def test_prefetch_iter_stops_and_reraises():
    def failing():
        yield 1
        raise KeyError("boom")

    it = port_dataset.prefetch_iter(failing(), 2)
    assert next(it) == 1
    with pytest.raises(KeyError):
        next(it)
    # an abandoned consumer stops the producer
    it = port_dataset.prefetch_iter(iter(range(100)), 1)
    assert next(it) == 0
    it.close()


def test_pair_loader_matches_jax(tmp_path):
    """The SegFormer trainer's loader over ``ResizedGlomerularDataset``
    with its augmentations: byte-identical batches."""
    _gtcs_tree(tmp_path, n_specimens=5, crops_per=1, size=72)
    root = str(tmp_path / "01_Todai" / "20260101")
    from glomeruli_segmentation_tpu.data import (
        segformer_dataset as jax_segformer_dataset,
    )

    def batches(seg, ds_mod, t):
        tf = t.Compose([t.RandomCropResize(16), t.RandomFlip(),
                        t.RandomVerticalFlip(),
                        t.RandomBlurringAndSharpning(), t.RandomContrast()])
        ds = ds_mod.ResizedGlomerularDataset(root, transforms=tf,
                                             mode="train", fold=1,
                                             input_size=64)
        return list(seg._PairLoader(ds, 2, True, 2))

    want = batches(jax_seg, jax_segformer_dataset, jax_t)
    got = batches(port_seg, port_segformer_dataset, port_t)
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        for a, b in zip(g, w):
            assert a.dtype == b.dtype and np.array_equal(a, b)


def test_load_data_matches_jax_and_cross_reads(tmp_path):
    """Equal statistics (mean of per-image BGR means and stds, class
    weights ``1/ln(1.10+p)``) and lists; each package's cache loads in
    the other's trainer as its own."""
    write_espnet_tree(tmp_path)
    want = jax_load.LoadData(str(tmp_path), 5,
                             str(tmp_path / "jax.p")).process_data()
    got = port_load.LoadData(str(tmp_path), 5,
                             str(tmp_path / "port.p")).process_data()
    assert got.keys() == want.keys()
    for key in got:
        if isinstance(got[key], list):
            assert got[key] == want[key]
        else:
            assert got[key].dtype == want[key].dtype == np.float32
            assert np.array_equal(got[key], want[key])
    assert len(got["trainIm"]) == 4 and len(got["valIm"]) == 2
    assert np.all(got["classWeights"] < 1 / np.log(1.10) + 1e-6)
    for path in ("jax.p", "port.p"):
        with open(tmp_path / path, "rb") as f:
            cached = pickle.load(f)
        assert all(np.array_equal(np.asarray(cached[k]), np.asarray(got[k]))
                   for k in got)


def test_create_dataset_txt_matches_jax(tmp_path):
    """The lists byte-identical through both commands."""
    write_espnet_tree(tmp_path, n_train=3, n_val=2)
    written = {}
    for name, cli in (("jax", jax_cli), ("port", port_cli)):
        cli.main(["--data_dir", str(tmp_path)])
        written[name] = [(tmp_path / f"{s}.txt").read_bytes()
                         for s in ("train", "val")]
    assert written["port"] == written["jax"]
    train = written["port"][0].decode().splitlines()
    assert len(train) == 3
    rgb, label = train[0].split(",")
    assert "/train/rgb/P0/" in rgb and "/train/label/P0/" in label
