"""The port's own copies of the JAX package's numpy-only modules on the
end-to-end path, held to the originals on seeded inputs: ``palette``,
``utils/target_list``, ``eval/boundary.bound2line``, ``utils/labelme_io``,
``pipeline/segment.build_labelme_doc``, ``pipeline/merge``,
``pipeline/seg_data.MAGNIFICATION``, and the ``gseg-merge`` and
``gseg-make-target-list`` commands (``cli/merge.py``,
``cli/make_target_list.py``)."""
import dataclasses
import json

import numpy as np
import pytest

from glomeruli_segmentation_tpu import palette as jax_palette
from glomeruli_segmentation_tpu.cli import make_target_list as jax_make_list
from glomeruli_segmentation_tpu.cli import merge as jax_cli_merge
from glomeruli_segmentation_tpu.eval import boundary as jax_boundary
from glomeruli_segmentation_tpu.pipeline import merge as jax_merge
from glomeruli_segmentation_tpu.pipeline import seg_data as jax_seg_data
from glomeruli_segmentation_tpu.pipeline import segment as jax_segment
from glomeruli_segmentation_tpu.utils import labelme_io as jax_labelme
from glomeruli_segmentation_tpu.utils import target_list as jax_targets
from glomeruli_segmentation_tpu_torch import palette
from glomeruli_segmentation_tpu_torch.cli import make_target_list
from glomeruli_segmentation_tpu_torch.cli import merge as cli_merge
from glomeruli_segmentation_tpu_torch.eval import boundary
from glomeruli_segmentation_tpu_torch.pipeline import merge, seg_data, segment
from glomeruli_segmentation_tpu_torch.utils import labelme_io, target_list


def _class_map(seed, h=240, w=320, classes=5):
    """Rough-edged nested discs of every class on a background, big enough
    that each class keeps contours past bound2line's point counts."""
    rng = np.random.RandomState(seed)
    out = np.zeros((h, w), np.uint8)
    yy, xx = np.mgrid[:h, :w]
    for _ in range(3):
        cy, cx = rng.randint(60, h - 60), rng.randint(60, w - 60)
        r = rng.randint(40, 60)
        d = np.sqrt((yy - cy) ** 2 + (xx - cx) ** 2) + \
            rng.uniform(0, 3, (h, w))
        for c in range(1, classes):
            out[d < r * (classes - c + 1) / classes] = c
    return out


def test_palette_matches_jax():
    for name in ("ESPNET_PALETTE", "TRAIN_PALETTE", "GTCS_PALETTE",
                 "LABEL_NAMES", "LABEL_NAME_TO_VALUE",
                 "GTCS_LABEL_NAME_TO_VALUE", "GTCS_LABEL_NAMES",
                 "PRED_LABEL_IDX"):
        assert getattr(palette, name) == getattr(jax_palette, name), name
    for n in (5, 255, 256):
        np.testing.assert_array_equal(palette.label_colormap(n),
                                      jax_palette.label_colormap(n))
    labels = np.random.RandomState(0).randint(0, 30, (40, 50)).astype(
        np.uint8)
    for pal in (palette.ESPNET_PALETTE, palette.GTCS_PALETTE):
        for bgr in (True, False):
            np.testing.assert_array_equal(
                palette.colorize(labels, pal, bgr=bgr),
                jax_palette.colorize(labels, pal, bgr=bgr))
    for fn in ("relabel_to_cityscapes", "relabel_from_cityscapes",
               "relabel_4cls"):
        np.testing.assert_array_equal(getattr(palette, fn)(labels),
                                      getattr(jax_palette, fn)(labels))


def test_target_list_matches_jax(tmp_path):
    path = tmp_path / "targets.txt"
    path.write_text("H16-1/H16-1_PAS.ndpi\n"
                    "\n"
                    "#H16-2/skip.ndpi\n"
                    "H16-3/img.png,2048,1536,40,8,0.2265,0.2265\n"
                    "H16-4\n")
    got = target_list.read_target_list(str(path))
    want = jax_targets.read_target_list(str(path))
    assert [dataclasses.asdict(e) for e in got] == \
        [dataclasses.asdict(e) for e in want]
    assert [e.is_comment for e in got] == [False, True, False, False]
    assert {k: dataclasses.asdict(v) for k, v in
            target_list.metadata_by_file_id(str(path)).items()} == \
        {k: dataclasses.asdict(v) for k, v in
         jax_targets.metadata_by_file_id(str(path)).items()}
    assert target_list.parse_target_line("  ") is None


@pytest.mark.parametrize("seed,max_classes", [(0, -1), (1, 4), (2, 3)])
def test_bound2line_matches_jax(seed, max_classes):
    cmap = _class_map(seed)
    got = boundary.bound2line(cmap, max_classes=max_classes)
    want = jax_boundary.bound2line(cmap, max_classes=max_classes)
    assert sorted(got) == sorted(want) and got
    for cls in want:
        assert len(got[cls]) == len(want[cls])
        for a, b in zip(got[cls], want[cls]):
            np.testing.assert_array_equal(a, b)


def test_labelme_io_matches_jax(tmp_path):
    rng = np.random.RandomState(4)
    rgb = rng.randint(0, 256, (30, 40, 3)).astype(np.uint8)
    cmap = _class_map(3)
    for img in (rgb, cmap):
        b64 = labelme_io.img_arr_to_b64(img)
        assert b64 == jax_labelme.img_arr_to_b64(img)
        np.testing.assert_array_equal(labelme_io.img_b64_to_arr(b64), img)
    shapes = [{"label": "glomerulus",
               "points": [[5, 5], [70, 8], [60, 50], [8, 40]]},
              {"label": "crescent", "points": [[20, 20], [40, 20], [30, 35]]},
              {"label": "mesangium", "points": [[30, 10], [50, 12],
                                                [45, 30]]}]
    names = ["glomerulus", "crescent", "mesangium"]
    np.testing.assert_array_equal(
        labelme_io.polygons_to_mask((60, 80), shapes[0]["points"]),
        jax_labelme.polygons_to_mask((60, 80), shapes[0]["points"]))
    got = labelme_io.shapes_to_label((60, 80), shapes,
                                     palette.LABEL_NAME_TO_VALUE, names)
    np.testing.assert_array_equal(got, jax_labelme.shapes_to_label(
        (60, 80), shapes, jax_palette.LABEL_NAME_TO_VALUE, names))
    labelme_io.lblsave(str(tmp_path / "port"), got)
    jax_labelme.lblsave(str(tmp_path / "jax"), got)
    assert (tmp_path / "port.png").read_bytes() == \
        (tmp_path / "jax.png").read_bytes()
    doc = {"shapes": shapes, "imagePath": "x.PNG",
           "imageData": labelme_io.img_arr_to_b64(rgb)}
    (tmp_path / "doc.json").write_text(json.dumps(doc))
    loaded = labelme_io.load_labelme_json(str(tmp_path / "doc.json"))
    assert loaded == jax_labelme.load_labelme_json(str(tmp_path / "doc.json"))
    np.testing.assert_array_equal(
        labelme_io.labelme_image_array(loaded, str(tmp_path / "doc.json")),
        rgb)


@pytest.mark.parametrize("seed,relabel", [(0, False), (5, False),
                                          (0, True)])
def test_build_labelme_doc_matches_jax(seed, relabel):
    """On raw class ids, and on the cityscapes ids the end-to-end path
    writes (there class 1's mask is the whole crop and the rest match
    nothing, so no polygon survives, in both packages)."""
    cmap = _class_map(seed)
    if relabel:
        cmap = palette.relabel_to_cityscapes(cmap)
    got = segment.build_labelme_doc(cmap, cmap, "xmin1_ymin2_xmax3_ymax4.PNG")
    want = jax_segment.build_labelme_doc(cmap, cmap,
                                         "xmin1_ymin2_xmax3_ymax4.PNG")
    assert json.dumps(got, indent=4) == json.dumps(want, indent=4)
    assert bool(got["shapes"]) == (not relabel)
    assert seg_data.MAGNIFICATION == jax_seg_data.MAGNIFICATION


def _candidates(seed, n=60, mpp=0.25):
    """Overlapping boxes of glomerulus size (in level-0 px at ``mpp``) in
    tight clusters, so merges chain, plus oversized and disjoint ones."""
    rng = np.random.RandomState(seed)
    out = []
    centers = rng.uniform(500, 4000, (6, 2))
    for i in range(n):
        cx, cy = centers[i % len(centers)] + rng.normal(0, 60, 2)
        w, h = rng.uniform(100, 900, 2) if i % 9 else rng.uniform(1500,
                                                                  2000, 2)
        x1, y1 = float(int(cx - w / 2)), float(int(cy - h / 2))
        x2, y2 = x1 + float(int(w)), y1 + float(int(h))
        out.append([x1, y1, x2, y2, float(np.float32(rng.uniform(0.2, 1))),
                    (x2 - x1) * (y2 - y1), 0.0])
    return out


@pytest.mark.parametrize("seed,threshold", [(0, 0.35), (1, 0.35), (2, 0.1),
                                            (3, 0.8)])
def test_box_merger_matches_jax(seed, threshold):
    cands = _candidates(seed)
    got = merge.BoxMerger(threshold).merge_all(
        [list(c) for c in cands], 0.25, 0.25)
    want = jax_merge.BoxMerger(threshold).merge_all(
        [list(c) for c in cands], 0.25, 0.25)
    assert got == want
    assert 1 < len(got) < len(cands)
    for a, b in zip(cands[:-1], cands[1:]):
        assert merge.overlap_area(a, b) == jax_merge.overlap_area(a, b)


def _detect_csv(tmp_path):
    """A detect CSV of two slides (PNG inputs with metadata in the target
    list) -> (its path, the target list's path)."""
    targets = tmp_path / "targets.txt"
    targets.write_text("P1/a,4096,4096,40,8,0.25,0.25\n"
                       "P2/b,4096,4096,40,8,0.3,0.3\n")
    lines = []
    for pid, name, seed in (("P1", "a.png", 0), ("P2", "b.png", 1)):
        for x1, y1, x2, y2, conf, _, _ in _candidates(seed, n=30):
            lines.append(f'"s","{pid}","{name}",new,T,{x1},{y1},{x2},{y2},'
                         f'{conf}\n')
    detect_csv = tmp_path / "detect.csv"
    detect_csv.write_text("".join(lines))
    return detect_csv, targets


def test_run_merge_matches_jax(tmp_path):
    """The staged merger over a detect CSV of two slides: the same merged
    CSV; the timing log's file column the same."""
    detect_csv, targets = _detect_csv(tmp_path)
    outs = {}
    for name, mod in (("port", merge), ("jax", jax_merge)):
        outs[name] = mod.run_merge("OPT_PAS", str(detect_csv),
                                   str(tmp_path / name), "t", 0.5,
                                   str(tmp_path), 0.35, str(targets))
    got = open(outs["port"]).read()
    assert got == open(outs["jax"]).read() and got.count("\n") > 2
    logs = [[ln.split(",")[0] for ln in open(p.replace(".csv", "_log.csv"))]
            for p in (outs["port"], outs["jax"])]
    assert logs[0] == logs[1] == ['"a.png"', '"b.png"']
    bad = tmp_path / "bad.csv"
    bad.write_text('"s","P9","c.png",new,T,1,2,3,4,0.9\n')
    with pytest.raises(merge.MergeOverlappedGlomeruliError):
        merge.run_merge("OPT_PAS", str(bad), str(tmp_path / "bad"), "t",
                        0.5, str(tmp_path), 0.35, str(targets))


def test_merge_cli_matches_jax(tmp_path):
    """``cli/merge.main`` on a detect CSV: the merged CSV byte-identical to
    the JAX package's, the timing log's file column the same."""
    detect_csv, targets = _detect_csv(tmp_path)
    for name, mod in (("port", cli_merge), ("jax", jax_cli_merge)):
        mod.main(["--staining", "OPT_PAS", "--target_list", str(targets),
                  "--detected_list", str(detect_csv),
                  "--output_dir", str(tmp_path / name),
                  "--output_file_ext", "c", "--conf_threshold", "0.5",
                  "--data_dir", str(tmp_path), "--overlap_threshold", "0.35"])
    got = (tmp_path / "port" / "OPT_PAS_GlomusMergedList_c.csv").read_bytes()
    assert got == (tmp_path / "jax" /
                   "OPT_PAS_GlomusMergedList_c.csv").read_bytes()
    assert got.count(b"\n") > 2
    logs = [[ln.split(",")[0] for ln in (tmp_path / name /
             "OPT_PAS_GlomusMergedList_c_log.csv").read_text().splitlines()]
            for name in ("port", "jax")]
    assert logs[0] == logs[1] == ['"a.png"', '"b.png"']


def test_make_target_list_cli_matches_jax(tmp_path):
    """``cli/make_target_list.main``: the same target list as the JAX
    package's from one base CSV and slide directory, and the same refusal
    of a directory without exactly one slide."""
    data = tmp_path / "slides"
    for d, f in (("H16-2", "H16-2_PAS.ndpi"), ("H16-1", "x.tiff"),
                 ("H16-3", "y.tif")):
        (data / d).mkdir(parents=True)
        (data / d / f).write_bytes(b"")
    (data / "H16-1" / "notes.txt").write_text("")
    base = tmp_path / "base.csv"
    base.write_text("a,b,c,H16-2\na,b,c,H16-1\na,b,c,H16-3\na,b,c,H16-1\n")
    for name, mod in (("port", make_target_list), ("jax", jax_make_list)):
        mod.main(["--base_list_csv", str(base), "--data_dir", str(data),
                  "--output_file", str(tmp_path / f"{name}.txt")])
    got = (tmp_path / "port.txt").read_text()
    assert got == (tmp_path / "jax.txt").read_text()
    assert got == "H16-1/x\nH16-2/H16-2_PAS\nH16-3/y\n"
    (data / "H16-3" / "z.tif").write_bytes(b"")
    for mod in (make_target_list, jax_make_list):
        with pytest.raises(AssertionError):
            mod.main(["--base_list_csv", str(base), "--data_dir", str(data),
                      "--output_file", str(tmp_path / "bad.txt")])


@pytest.mark.parametrize("dtype", [np.uint8, np.int32, np.int64])
def test_relabel_to_cityscapes_matches_jax_on_every_id(dtype):
    """The port's table lookup against the JAX package's pass per class:
    every byte value (19 and 255 go to 0, ids past 19 stay), ids past 255
    in a wider type, and an empty map."""
    ids = np.arange(256).reshape(16, 16).astype(dtype)
    if dtype != np.uint8:
        ids = np.concatenate([ids, ids + 256])
    for labels in (ids, ids[:0]):
        got = palette.relabel_to_cityscapes(labels)
        want = jax_palette.relabel_to_cityscapes(labels)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
