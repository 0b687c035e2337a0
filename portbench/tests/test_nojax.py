"""Nothing the benchmark loads may bring in JAX or the JAX package: after
importing ``portbench.run`` and every module a run can load (stages,
families, references, metric readers and the port's modules they use), no
module's top-level name is ``jax``, ``jaxlib``, ``flax`` or
``glomeruli_segmentation_tpu``."""
import subprocess
import sys

from portbench import harness

PROBE = """
import importlib, sys
sys.path.insert(0, {root!r})
import portbench.run
from portbench import harness, control, tracecheck
for m in ("portbench.stages.segment", "portbench.families.espnet_ensemble",
          "portbench.families.segformer"):
    importlib.import_module(m)
for m in harness.manifest()["per_layer"]:
    harness.reader(m["name"])
import glomeruli_segmentation_tpu_torch.pipeline.fused
import glomeruli_segmentation_tpu_torch.pipeline.fused_segformer
print(",".join(harness.forbidden_modules()) or "clean")
"""


def test_no_jax_after_a_dry_import():
    out = subprocess.run([sys.executable, "-c",
                          PROBE.format(root=str(harness.ROOT))],
                         capture_output=True, text=True, timeout=300,
                         cwd=str(harness.ROOT))
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "clean"


def test_the_names_are_compared_whole():
    assert harness.forbidden_modules(
        ["glomeruli_segmentation_tpu_torch.ops.nms", "jaxtyping",
         "flaxen", "numpy"]) == []
    assert harness.forbidden_modules(
        ["jax.numpy", "glomeruli_segmentation_tpu.ops", "flax", "jaxlib",
         "torch"]) == ["flax", "glomeruli_segmentation_tpu", "jax",
                       "jaxlib"]


def test_a_run_refuses_without_a_card(tmp_path):
    out = subprocess.run(
        [sys.executable, str(harness.HERE / "run.py"), "--workload",
         "espnet5-glom-dense", "--seed", "1", "--seconds", "1"],
        capture_output=True, text=True, timeout=300, cwd=str(harness.ROOT),
        env={"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin",
             "HOME": str(tmp_path)})
    assert out.returncode != 0 and out.stdout.strip() == ""
