"""The port imports neither JAX nor the JAX package: every module of
``glomeruli_segmentation_tpu_torch`` and ``chip_smoke.py`` import in a
process where ``import jax`` fails."""
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parent.parent

GUARD = r"""
import importlib, pkgutil, sys
sys.modules["jax"] = None          # any "import jax" now raises
import glomeruli_segmentation_tpu_torch as port
names = [port.__name__] + [m.name for m in pkgutil.walk_packages(
    port.__path__, port.__name__ + ".")]
for name in names:
    importlib.import_module(name)
importlib.import_module("chip_smoke")
leaked = sorted(m for m in sys.modules
                if m == "glomeruli_segmentation_tpu"
                or m.startswith("glomeruli_segmentation_tpu."))
print(len(names), "modules")
assert not leaked, leaked
assert "torch" in sys.modules
"""


def test_port_and_chip_smoke_import_without_jax():
    proc = subprocess.run([sys.executable, "-c", GUARD], cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    count = int(proc.stdout.split()[0])
    # the package, its subpackages, the detector slice's modules, the
    # frozen-graph detector's (convert/pb_import, ops/resize,
    # models/inception_v2, models/od_api_frcnn) and the end-to-end slice's
    # (palette, eval, eval/boundary, cli, cli/detect, cli/e2e, pipeline/
    # e2e, merge, segment, seg_data, utils/labelme_io, utils/target_list,
    # wsi/tiff_reader, wsi/synthetic) and the server and detect-stage
    # slice's (pipeline/serve, cli/serve, cli/warmup, cli/merge,
    # cli/make_target_list) and the staged segment-and-evaluate chain's
    # (utils/annotation, utils/timing, eval/iou_eval, pipeline/eval_wsi,
    # cli/make_seg_data, cli/segment, cli/eval_wsi) and the SegFormer/GTCS
    # family's (data, data/segformer_dataset, models/segformer,
    # convert/segformer_import, eval/mean_iou, pipeline/fused_segformer,
    # pipeline/segformer_test, pipeline/eval_wsi_gtcs, cli/segformer_test,
    # cli/eval_wsi_gtcs) and the native reader, selftest and tools slice's
    # (wsi/native, wsi/native/_build, wsi/native_reader, pipeline/selftest,
    # cli/selftest, utils/summary, tools and its six scripts) and the
    # training slice's (data/transforms, data/dataset, data/load_data,
    # train, train/criteria, train/batch_norm, train/espnet_train,
    # train/segformer_train, cli/train, cli/create_dataset_txt,
    # cli/segformer_train) and the detector training slice's
    # (train/detector_train, train/detector_driver, train/od_api_finetune,
    # cli/train_detector)
    assert count >= 91, proc.stdout


def test_native_reader_builds_from_the_ports_own_files():
    """The reader is compiled from the port's copy of the source and
    headers into the ignored ``build/`` tree, never from the JAX package's
    ``wsi/native/``."""
    from glomeruli_segmentation_tpu_torch.wsi.native import _build

    port = ROOT / "glomeruli_segmentation_tpu_torch" / "wsi" / "native"
    assert _build.SOURCE == port / "ndpi_reader.cc"
    assert _build.INCLUDE == port / "include"
    assert _build.BUILD_DIR == ROOT / "build" / "native_reader"
    headers = {p.name for p in _build.INCLUDE.iterdir()}
    assert {"jpeglib.h", "jconfig.h", "jmorecfg.h", "jerror.h", "zlib.h",
            "zconf.h", "LICENSE.libjpeg-turbo", "LICENSE.zlib"} <= headers
    command = " ".join(_build._command(ROOT / "out.so", ["libjpeg.so.62"]))
    assert "glomeruli_segmentation_tpu/" not in command
    assert "build/" in (ROOT / ".gitignore").read_text().split()
