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
    # cli/make_seg_data, cli/segment, cli/eval_wsi)
    assert count >= 53, proc.stdout
