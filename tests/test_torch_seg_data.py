"""The port's segmentation-data stage (``utils/annotation.py``,
``pipeline/seg_data.py``, ``cli/make_seg_data.py``) against the JAX
package's on the CPU: the same annotation XML, merged CSV and slide give
the same GT boxes, ``scan_files`` rows and byte-identical crop and label
PNGs, in GT and no-GT mode.  :func:`write_tree` builds the example-data
layout the other staged-chain tests share."""
import json
import os

import numpy as np
import pytest

from glomeruli_segmentation_tpu.cli import make_seg_data as jax_cli
from glomeruli_segmentation_tpu.pipeline import seg_data as jax_seg_data
from glomeruli_segmentation_tpu.utils import annotation as jax_annotation
from glomeruli_segmentation_tpu_torch import wsi as port_wsi
from glomeruli_segmentation_tpu_torch.cli import make_seg_data as port_cli
from glomeruli_segmentation_tpu_torch.pipeline import seg_data
from glomeruli_segmentation_tpu_torch.pipeline.merge import run_merge
from glomeruli_segmentation_tpu_torch.utils import annotation
from glomeruli_segmentation_tpu_torch.utils.labelme_io import img_arr_to_b64
from glomeruli_segmentation_tpu_torch.wsi.synthetic import (
    pas_like_image,
    write_pyramidal_tiff,
)

PATIENT = "H17-02419"
MPP = 0.25
HEIGHT, WIDTH = 1536, 2048
PACKAGES = {"port": seg_data, "jax": jax_seg_data}


def write_tree(root, seed=11):
    """The example-data layout around a 1536x2048 synthetic pyramid (as
    ``tests/test_pipeline_integration.py``'s fixture builds it): the slide
    under ``data/02_PAS/<patient>/``, a Pascal-VOC XML at ds8, one labelme
    GT JSON per box sized to its margin frame, a detection CSV (the GT
    boxes grown by 8 px, the second GT box, which overlaps no other, left
    undetected, one clean false positive), the target list, and the merged CSV of ``run_merge`` at
    0.9 / 0.35."""
    img, centers = pas_like_image(HEIGHT, WIDTH, seed=seed, n_glomeruli=4)
    wsi_dir = root / "data" / "02_PAS"
    slide_dir = wsi_dir / PATIENT
    slide_dir.mkdir(parents=True)
    write_pyramidal_tiff(str(slide_dir / f"{PATIENT}.tiff"), img, mpp=MPP,
                         objective_power=40.0, tile_size=256, levels=3)
    margin = int(round(20.0 / MPP))
    gt_boxes = []
    for cx, cy, r in centers:
        x1, y1 = (cx - r - 16) // 8 * 8, (cy - r - 16) // 8 * 8
        x2, y2 = (cx + r + 16) // 8 * 8, (cy + r + 16) // 8 * 8
        if (x1 - margin < 0 or y1 - margin < 0 or x2 + 2 * margin > WIDTH
                or y2 + 2 * margin > HEIGHT):
            continue
        gt_boxes.append((x1, y1, x2, y2, (cx, cy, r)))
    assert len(gt_boxes) >= 3, "the fixture needs TPs and an FN"
    fn = gt_boxes[1]
    assert all(annotation.rect_iou(fn[:4], b[:4]) == 0
               for b in gt_boxes if b is not fn), "the FN box overlaps"
    ann_dir = slide_dir / "annotations"
    ann_dir.mkdir()
    objects = "".join(
        f"  <object><name>glomerulus</name><bndbox><xmin>{x1 // 8}</xmin>"
        f"<ymin>{y1 // 8}</ymin><xmax>{x2 // 8}</xmax><ymax>{y2 // 8}"
        f"</ymax></bndbox></object>\n" for x1, y1, x2, y2, _ in gt_boxes)
    (ann_dir / f"OPT_PAS_{PATIENT}_{PATIENT}_pw40_ds8.xml").write_text(
        f"<annotation>\n{objects}</annotation>\n")
    seg_gt_dir = root / "seg_annotation" / PATIENT
    seg_gt_dir.mkdir(parents=True)
    for x1, y1, x2, y2, (cx, cy, r) in gt_boxes:
        fx1, fy1 = x1 - margin, y1 - margin
        fx2, fy2 = x2 + 2 * margin, y2 + 2 * margin
        theta = np.linspace(0, 2 * np.pi, 40)
        points = [[float(cx - fx1 + r * np.cos(t)),
                   float(cy - fy1 + r * np.sin(t))] for t in theta]
        doc = {"shapes": [{"label": "glomerulus", "points": points,
                           "line_color": None, "fill_color": None}],
               "imagePath": "frame.png",
               "imageData": img_arr_to_b64(img[fy1:fy2, fx1:fx2])}
        (seg_gt_dir / f"xmin{x1 // 8}_ymin{y1 // 8}_xmax{x2 // 8}"
                      f"_ymax{y2 // 8}.json").write_text(json.dumps(doc))
    rows = [f'"S","{PATIENT}","{PATIENT}.tiff",new,2026-01-01T00:00:00,'
            f"{x1 - 8},{y1 - 8},{x2 + 8},{y2 + 8},0.97"
            for x1, y1, x2, y2, _ in gt_boxes if (x1, y1) != fn[:2]]
    rows.append(f'"S","{PATIENT}","{PATIENT}.tiff",new,2026-01-01T00:00:00,'
                f"8,8,168,168,0.95")
    detect_csv = root / "OPT_PAS_test1.csv"
    detect_csv.write_text("\n".join(rows) + "\n")
    target_list = root / "targets.txt"
    target_list.write_text(f"{PATIENT}/{PATIENT}\n")
    merged_csv = run_merge("OPT_PAS", str(detect_csv), str(root / "merged"),
                           "test1", conf_threshold=0.9,
                           annotation_dir=str(root / "data"),
                           overlap_threshold=0.35,
                           target_list=str(target_list))
    return dict(root=root, img=img, wsi_dir=wsi_dir, data_dir=root / "data",
                detect_csv=detect_csv, target_list=target_list,
                merged_csv=merged_csv, gt_boxes=gt_boxes,
                seg_gt_dir=root / "seg_annotation", ann_dir=ann_dir)


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    return write_tree(tmp_path_factory.mktemp("seg_data"))


def tree_files(folder):
    """Every file under ``folder`` -> its bytes."""
    return {str(p.relative_to(folder)): p.read_bytes()
            for p in sorted(folder.rglob("*")) if p.is_file()}


def test_annotation_matches_jax(tree):
    """The XML's boxes and names, ``rect_iou``, and an unknown staining
    (an empty staining directory in both: the registry answers "", which
    the ``is None`` check lets through)."""
    name = f"OPT_PAS_{PATIENT}_{PATIENT}_pw40_ds8.xml"
    got = {}
    for key, mod in (("port", annotation), ("jax", jax_annotation)):
        h = mod.AnnotationHandler(str(tree["data_dir"]), "OPT_PAS")
        h.read_annotation(str(tree["ann_dir"]), name)
        got[key] = (list(h.gt_list), list(h.gt_name_list), h.staining_dir)
        h.clear_annotation()
        assert h.gt_list == [] and h.gt_name_list == []
        got[key] += (mod.AnnotationHandler(str(tree["data_dir"]),
                                           "OPT_XX").staining_dir,)
    assert got["port"] == got["jax"]
    assert len(got["port"][0]) == len(tree["gt_boxes"])
    assert got["port"][2:] == ("02_PAS", "")
    assert annotation.ANNOTATION_FILE_PATTERN == \
        jax_annotation.ANNOTATION_FILE_PATTERN
    rng = np.random.RandomState(0)
    for _ in range(200):
        a = sorted(rng.randint(0, 50, 2)) + sorted(rng.randint(0, 50, 2))
        b = sorted(rng.randint(0, 50, 2)) + sorted(rng.randint(0, 50, 2))
        a, b = [a[0], a[2], a[1] + 1, a[3] + 1], [b[0], b[2], b[1] + 1,
                                                   b[3] + 1]
        assert annotation.rect_iou(a, b) == jax_annotation.rect_iou(a, b)
        assert annotation.AnnotationHandler.check_overlap(a, b) == \
            jax_annotation.AnnotationHandler.check_overlap(a, b)


def test_seg_data_helpers_match_jax(tree):
    assert seg_data.read_detected_glomus_list(tree["merged_csv"]) == \
        jax_seg_data.read_detected_glomus_list(tree["merged_csv"])
    assert seg_data.find_slide(str(tree["wsi_dir"]), PATIENT) == \
        jax_seg_data.find_slide(str(tree["wsi_dir"]), PATIENT)
    with pytest.raises(FileNotFoundError):
        seg_data.find_slide(str(tree["wsi_dir"]), "H00-00000")
    slide = port_wsi.open_slide(
        seg_data.find_slide(str(tree["wsi_dir"]), PATIENT))
    assert seg_data.slide_margins(slide) == (80, 80)
    for rect in ([8, 8, 168, 168], [1003.5, 17, 1399, 2000.9]):
        assert seg_data.crop_name(rect) == jax_seg_data.crop_name(rect)
    for name in ("MAGNIFICATION", "MARGIN_UM", "LABEL_NAME_TO_VALUE",
                 "GLOMUS_CATEGORIES", "SLIDE_EXTENSIONS"):
        assert getattr(seg_data, name) == getattr(jax_seg_data, name), name
    assert seg_data.ANNOTATION_DATE_PATTERN.pattern == \
        jax_seg_data.ANNOTATION_DATE_PATTERN.pattern


def test_seg_data_gt_mode_matches_jax(tree, tmp_path, capsys):
    """``scan_files``: the same rows (one GT box is a false negative) and
    byte-identical crops and labels, the FP's all-background label
    included."""
    rows, files = {}, {}
    for key, mod in PACKAGES.items():
        out = tmp_path / key
        gen = mod.SegDataGenerator(
            "OPT_PAS", str(tree["data_dir"]), str(tree["target_list"]),
            tree["merged_csv"], iou_threshold=0.01, output_dir=str(out),
            wsi_dir=str(tree["wsi_dir"]), gt_png_dir=None,
            seg_gt_json_dir=str(tree["seg_gt_dir"]))
        gen.read_detected_glomus_list()
        rows[key] = gen.scan_files()
        files[key] = tree_files(out)
    assert rows["port"] == rows["jax"]
    (_, recall, hits, n_gt, n_det), = rows["port"]
    n = len(tree["gt_boxes"])
    merged = open(tree["merged_csv"]).read().splitlines()
    assert (recall, hits, n_gt, n_det) == ((n - 1) / n, n - 1, str(n),
                                           str(len(merged)))
    assert files["port"] == files["jax"]
    crops = [k for k in files["port"] if k.startswith("org_image/")]
    labels = [k for k in files["port"] if k.startswith("label/all/")]
    assert len(crops) == len(labels) == len(merged)   # the TPs and the FP
    printed = capsys.readouterr().out.splitlines()
    assert printed[0] == printed[2] == "data,recall,recall_hit_num,gt_num," \
                                       "detect_num"


def test_make_seg_data_cli_matches_jax(tree, tmp_path):
    """Both commands in GT mode and in no-GT mode (crops only):
    byte-identical trees; the parsers agree."""
    base = ["--staining", "OPT_PAS", "--merged_detection_result_csv",
            tree["merged_csv"], "--target_list", str(tree["target_list"]),
            "--wsi_dir", str(tree["wsi_dir"])]
    gt = ["--segmentation_gt_json_dir", str(tree["seg_gt_dir"]),
          "--object_detection_gt_xml_dir", str(tree["data_dir"])]
    for mode, extra in (("gt", gt), ("no_gt", [])):
        files = {}
        for key, cli in (("port", port_cli), ("jax", jax_cli)):
            out = tmp_path / mode / key
            argv = base + extra + ["--output_dir", str(out)]
            assert vars(cli.build_parser().parse_args(argv)) == \
                vars(jax_cli.build_parser().parse_args(argv))
            cli.main(argv)
            files[key] = tree_files(out)
        assert files["port"] == files["jax"], mode
        assert any(k.startswith("org_image/") for k in files["port"])
        assert any(k.startswith("label/") for k in files["port"]) == \
            (mode == "gt")
    defaults = vars(port_cli.build_parser().parse_args(base))
    assert defaults == vars(jax_cli.build_parser().parse_args(base))
    assert (defaults["iou_threshold"], defaults["output_dir"]) == \
        (0.01, "./output/seg_data")
    assert os.path.basename(port_cli.__file__) == "make_seg_data.py"
