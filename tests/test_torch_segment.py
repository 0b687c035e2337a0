"""The port's per-crop segmentation stage (``ops/preprocess.py``'s
``preprocess_host`` and ``preprocess_batch_device``,
``pipeline/segment.py``'s ``EspnetSegmenter`` and ``run_segment``,
``cli/segment.py``) against the JAX package's on the CPU, at small widths:
``random_state_dict`` weights (p=2, q=2, BN statistics calibrated at the
128x256 network input), both engines (the JAX fused engine in Pallas
interpret mode, the port's through K1's plain version), ESPNet and
ESPNet-C, the cv2 and the ``--fast`` preprocessing."""
import os

import cv2
import numpy as np
import pytest
import torch

from glomeruli_segmentation_tpu.cli import segment as jax_cli
from glomeruli_segmentation_tpu.ops import preprocess as jax_preprocess
from glomeruli_segmentation_tpu.pipeline import segment as jax_segment
from glomeruli_segmentation_tpu_torch.cli import segment as port_cli
from glomeruli_segmentation_tpu_torch.convert.espnet_import import (
    random_state_dict,
)
from glomeruli_segmentation_tpu_torch.ops import preprocess
from glomeruli_segmentation_tpu_torch.pipeline import segment
from glomeruli_segmentation_tpu_torch.utils.labelme_io import lblsave
from glomeruli_segmentation_tpu_torch.wsi.synthetic import pas_like_image
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

MEAN = [204.60071, 170.19359, 199.57469]
STD = [20.61257, 42.92207, 28.401505]
SMALL = dict(p=2, q=2, in_width=256, in_height=128, mean=MEAN, std=STD)
PATIENTS = ("H17-00001", "H17-00002")


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    path = tmp_path_factory.mktemp("segment_w") / "espnet_fold1.pth"
    torch.save(random_state_dict(1, 5, p=2, q=2, calib_size=(128, 256)),
               path)
    return str(path)


def make_crops(seed=3, n=5):
    """``n`` BGR uint8 crops of PAS-like glomeruli, 150 to 380 px a side,
    and a label map for each (nested discs of classes 1 to 4)."""
    rng = np.random.RandomState(seed)
    img, _ = pas_like_image(600, 800, seed=seed, n_glomeruli=6)
    crops, labels = [], []
    for _ in range(n):
        h, w = rng.randint(150, 300), rng.randint(150, 380)
        y, x = rng.randint(0, 600 - h), rng.randint(0, 800 - w)
        crops.append(np.ascontiguousarray(img[y:y + h, x:x + w, ::-1]))
        yy, xx = np.mgrid[:h, :w]
        d = np.hypot(yy - h / 2, xx - w / 2)
        r = min(h, w) / 2
        labels.append(np.select([d < r * f for f in (0.2, 0.4, 0.6, 0.8)],
                                [4, 3, 2, 1], 0).astype(np.uint8))
    return crops, labels


@pytest.fixture(scope="module")
def crop_dirs(tmp_path_factory):
    """``org_image/<patient>/xmin.._ymax...PNG`` crops and palette label
    PNGs of the same names under ``label/<patient>/``: three crops for the
    first patient, two for the second."""
    root = tmp_path_factory.mktemp("segment_crops")
    crops, labels = make_crops()
    for i, (crop, label) in enumerate(zip(crops, labels)):
        pid = PATIENTS[i // 3]
        name = f"xmin{10 * i}_ymin{5 * i}_xmax{10 * i + 40}_ymax{5 * i + 30}"
        for sub in ("org_image", "label"):
            (root / sub / pid).mkdir(parents=True, exist_ok=True)
        cv2.imwrite(str(root / "org_image" / pid / f"{name}.PNG"), crop)
        lblsave(str(root / "label" / pid / f"{name}.PNG"), label)
    return root


def test_preprocess_host_matches_jax():
    crops, _ = make_crops(seed=4, n=3)
    for crop in crops:
        for size in ((256, 128), (1024, 512)):
            got = preprocess.preprocess_host(crop, MEAN, STD, *size)
            want = jax_preprocess.preprocess_host(crop, MEAN, STD, *size)
            assert got.dtype == want.dtype == np.float32
            assert got.tobytes() == want.tobytes()


def test_preprocess_batch_device_matches_jax():
    crops, _ = make_crops(seed=5, n=4)
    max_h = max(c.shape[0] for c in crops)
    max_w = max(c.shape[1] for c in crops)
    padded = np.zeros((len(crops), max_h, max_w, 3), np.uint8)
    hs = np.asarray([c.shape[0] for c in crops], np.int32)
    ws = np.asarray([c.shape[1] for c in crops], np.int32)
    for i, c in enumerate(crops):
        padded[i, :c.shape[0], :c.shape[1]] = c
    mean_std = np.stack([MEAN, STD]).astype(np.float32)
    got = preprocess.preprocess_batch_device(
        torch.from_numpy(padded), torch.from_numpy(hs), torch.from_numpy(ws),
        torch.from_numpy(mean_std), 128, 256).numpy()
    want = np.asarray(jax_preprocess.preprocess_batch_device(
        padded, hs, ws, mean_std, 128, 256))
    assert got.shape == want.shape == (4, 128, 256, 3)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    # and the cv2 path, per crop, to float rounding
    for i, c in enumerate(crops):
        np.testing.assert_allclose(
            got[i], preprocess.preprocess_host(c, MEAN, STD, 256, 128),
            rtol=0, atol=1e-5)


CASES = {
    "xla-espnet": dict(engine="xla", decoder=True),
    "fused-espnet": dict(engine="fused", decoder=True),
    "xla-espnet_c": dict(engine="xla", decoder=False),
    "fused-espnet_c": dict(engine="fused", decoder=False),
    "xla-espnet-fast": dict(engine="xla", decoder=True,
                            device_preprocess=True),
    "fused-espnet-fast": dict(engine="fused", decoder=True,
                              device_preprocess=True),
}


@pytest.mark.parametrize("case", list(CASES))
def test_segmenter_class_maps_match_jax(case, weights):
    """Five crops at batch 2 (the last batch padded): network-resolution
    and crop-resolution class maps equal to the JAX package's."""
    kw = dict(weights=weights, batch_size=2, **SMALL, **CASES[case])
    crops, _ = make_crops()
    port = segment.EspnetSegmenter(segment.SegmenterConfig(**kw),
                                   device="cpu")
    jax_seg = jax_segment.EspnetSegmenter(jax_segment.SegmenterConfig(**kw))
    got = port.class_maps_net_res(crops)
    want = jax_seg.class_maps_net_res(crops)
    assert got.dtype == np.uint8 and got.shape == (5, 128, 256)
    np.testing.assert_array_equal(got, want)
    assert len(np.unique(got)) >= 3, "near-constant maps prove little"
    for a, b, crop in zip(port.segment_images(crops),
                          jax_seg.segment_images(crops), crops):
        assert a.shape == crop.shape[:2]
        np.testing.assert_array_equal(a, b)


def test_padded_last_batch_leaves_real_crops_alone(weights):
    """Padding the last batch with copies of its last crop changes no real
    crop's map: batch 2 over five crops equals batch 1 and batch 8."""
    crops, _ = make_crops()
    maps = {}
    for bs in (1, 2, 8):
        seg = segment.EspnetSegmenter(segment.SegmenterConfig(
            weights=weights, batch_size=bs, engine="fused", **SMALL),
            device="cpu")
        handle = seg.submit_net_res(crops[:min(bs, 5)])
        assert handle[1] == min(bs, 5)
        maps[bs] = seg.class_maps_net_res(crops)
    np.testing.assert_array_equal(maps[2], maps[1])
    np.testing.assert_array_equal(maps[8], maps[1])
    with pytest.raises(ValueError, match="1..batch_size"):
        seg.submit_net_res(crops * 2)


def test_compute_dtype_and_precision(weights, monkeypatch):
    """``compute_dtype`` picks the fused model's and the plain model's type;
    ``precision`` maps onto the TF32 switches during the forward."""
    seg = segment.EspnetSegmenter(segment.SegmenterConfig(
        weights=weights, compute_dtype="bfloat16", engine="fused", **SMALL),
        device="cpu")
    assert seg._fused.dtype == torch.bfloat16
    assert seg._fused.enc["level3"][0]["w1"].dtype == torch.bfloat16
    seg = segment.EspnetSegmenter(segment.SegmenterConfig(
        weights=weights, compute_dtype="bfloat16", **SMALL), device="cpu")
    assert next(seg.model.parameters()).dtype == torch.bfloat16
    crops, _ = make_crops(n=2)
    for precision, want in (("highest", False), ("high", False),
                            ("default", True)):
        seg = segment.EspnetSegmenter(segment.SegmenterConfig(
            weights=weights, precision=precision, **SMALL), device="cpu")
        seen = []
        forward = seg.model.forward

        def spy(x, forward=forward):
            seen.append((torch.backends.cudnn.allow_tf32,
                         torch.backends.cuda.matmul.allow_tf32))
            return forward(x)

        monkeypatch.setattr(seg.model, "forward", spy)
        seg.class_maps_net_res(crops)
        assert seen == [(want, want)], precision
    with pytest.raises(ValueError, match="compute_dtype"):
        segment.EspnetSegmenter(segment.SegmenterConfig(
            weights=weights, compute_dtype="float16", **SMALL), device="cpu")


def test_not_ported_and_bad_configs_raise(weights, tmp_path):
    """The configs the JAX package refuses raise; ``data_parallel`` and
    ``pack_output`` run as in the JAX package: the batch split over a data
    mesh of logical CPU devices, the packed readback unpacked on the host,
    both giving the one-device maps."""
    base = dict(weights=weights, **SMALL)
    crops = make_crops(n=4)[0]
    want = segment.EspnetSegmenter(segment.SegmenterConfig(**base),
                                   device="cpu").class_maps_net_res(crops)
    cpu = torch.device("cpu")
    for extra, devices in ((dict(data_parallel=2), [cpu] * 2),
                           (dict(data_parallel=-1), [cpu] * 4),
                           (dict(pack_output=True), None)):
        seg = segment.EspnetSegmenter(
            segment.SegmenterConfig(**{**base, **extra}), device="cpu",
            devices=devices)
        np.testing.assert_array_equal(seg.class_maps_net_res(crops), want)
    for extra, err, match in (
            (dict(data_parallel=2), ValueError, "requested a 2-device mesh"),
            (dict(data_parallel=2, engine="fused"), ValueError,
             "does not support data_parallel"),
            (dict(data_parallel=3), ValueError, "multiple of the data-axis"),
            (dict(engine="packed"), ValueError, "engine"),
            (dict(precision="low"), ValueError, "precision"),
            (dict(q=8), ValueError, "architecture")):
        with pytest.raises(err, match=match):
            segment.EspnetSegmenter(
                segment.SegmenterConfig(**{**base, **extra}), device="cpu",
                devices=[cpu] * 3 if extra.get("data_parallel") == 3
                else None)
    packed = segment.EspnetSegmenter(segment.SegmenterConfig(
        **base, pack_output=True), device="cpu")
    out, n = packed.submit_net_res(crops[:2])
    assert packed.read_net_res((out, n)).shape == (2, 128, 256)
    assert segment.read_host(out).shape == (8, 128, 86)
    with pytest.raises(SystemExit):
        segment.EspnetSegmenter(segment.SegmenterConfig(
            **dict(base, weights=str(tmp_path / "missing.pth"))),
            device="cpu")
    enc = tmp_path / "encoder_only.pth"
    torch.save(random_state_dict(2, 5, p=2, q=2, decoder=False), enc)
    with pytest.raises(ValueError, match="encoder-only"):
        segment.EspnetSegmenter(segment.SegmenterConfig(
            **dict(base, weights=str(enc))), device="cpu")
    # an encoder-only checkpoint runs as ESPNet-C
    seg = segment.EspnetSegmenter(segment.SegmenterConfig(
        **dict(base, weights=str(enc), decoder=False)), device="cpu")
    assert seg.class_maps_net_res(make_crops(n=1)[0]).shape == (1, 128, 256)


def test_segment_parser_matches_jax():
    argv = ["--rgb_data_dir", "a", "--weights", "w", "--mean", "1", "2",
            "3", "--std", "4", "5", "6"]
    got = vars(port_cli.build_parser().parse_args(argv))
    assert got == vars(jax_cli.build_parser().parse_args(argv))
    assert (got["engine"], got["batch_size"], got["precision"],
            got["gpu_id"], got["inWidth"], got["inHeight"]) == \
        ("xla", 8, "highest", -1, 1024, 512)
    full = argv + ["--label_data_dir", "l", "--decoder", "--cityFormat",
                   "--colored", "--overlay", "--json_image_data", "classmap",
                   "--engine", "fused", "--fast", "--skip_existing",
                   "--precision", "high", "--gpu_id", "3", "--modelType",
                   "2", "--data_parallel", "0", "--pack_output"]
    assert vars(port_cli.build_parser().parse_args(full)) == \
        vars(jax_cli.build_parser().parse_args(full))


def _tree(folder):
    return {str(p.relative_to(folder)): p.read_bytes()
            for p in sorted(folder.rglob("*")) if p.is_file()}


@pytest.mark.parametrize("engine", ["xla", "fused"])
def test_segment_cli_matches_jax(engine, weights, crop_dirs, tmp_path):
    """``cli/segment.main`` against the JAX ``main`` at batch 2 over five
    crops of two patients: every artifact byte-identical (JSONs with the
    class map, overlays, ``_org.png``, ``combined_images/``, the three
    summary CSVs, ``overall_accuracy.txt``); then, with two JSONs removed,
    ``--skip_existing`` redoes just those two in both."""
    def argv(out):
        return ["--rgb_data_dir", str(crop_dirs / "org_image"),
                "--label_data_dir", str(crop_dirs / "label"),
                "--savedir", str(out), "--weights", weights,
                "--inWidth", "256", "--inHeight", "128", "--p", "2",
                "--q", "2", "--decoder", "--cityFormat", "--colored",
                "--overlay", "--json_image_data", "classmap",
                "--batch_size", "2", "--engine", engine,
                "--mean", *map(str, MEAN), "--std", *map(str, STD)]

    outs = {"port": tmp_path / "port", "jax": tmp_path / "jax"}
    port_cli.main(argv(outs["port"]), device="cpu")
    jax_cli.main(argv(outs["jax"]))
    got, want = _tree(outs["port"]), _tree(outs["jax"])
    assert got.keys() == want.keys()
    assert [k for k in got if got[k] != want[k]] == []
    names = {os.path.basename(k) for k in got}
    assert {"summary_pixel.csv", "summary_accuracy.csv",
            "summary_dataset.csv", "overall_accuracy.txt"} <= names
    for pid, n in zip(PATIENTS, (3, 2)):
        for suffix in (".json", "_overlay.jpg", "_org.png"):
            assert len([k for k in got if k.startswith(pid + "/")
                        and k.endswith(suffix)]) == n
        assert len([k for k in got
                    if k.startswith(f"combined_images/{pid}/")]) == n
    rows = got["summary_pixel.csv"].decode().splitlines()[1:]
    for row in rows:
        name = row.split(",")[1].replace(".png", ".PNG")
        pid = row.split(",")[0]
        h, w = cv2.imread(str(crop_dirs / "org_image" / pid / name)).shape[:2]
        assert sum(int(v) for v in row.split(",")[2:]) == h * w

    for out in outs.values():
        for pid in PATIENTS:
            os.remove(sorted((out / pid).glob("*.json"))[0])
    port_cli.main(argv(outs["port"]) + ["--skip_existing"], device="cpu")
    jax_cli.main(argv(outs["jax"]) + ["--skip_existing"])
    got, want = _tree(outs["port"]), _tree(outs["jax"])
    assert [k for k in got if got[k] != want[k]] == []
    assert len(got["summary_pixel.csv"].decode().splitlines()) == 3


def test_segment_cli_runs_on_the_card_by_default(weights, crop_dirs,
                                                  tmp_path):
    """``main(argv)`` asks for the card; without one it raises rather than
    run on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        port_cli.main(["--rgb_data_dir", str(crop_dirs / "org_image"),
                       "--savedir", str(tmp_path), "--weights", weights,
                       "--p", "2", "--q", "2", "--decoder",
                       "--mean", *map(str, MEAN), "--std", *map(str, STD)])
