"""One run of one cell: the manifest, the cell's configuration and traffic
files found by name, its stage, the metrics it reports and the result
line.

A cell of ``BENCHMARK.json`` names a configuration (``configs/<name>.json``
beside this file, whose ``family`` names the model module under
``families/``) and a traffic mix (``traffic/<name>.json``, whose
``stage`` names the module under ``stages/`` that runs it).  A per-layer
metric is read by ``metrics/<name>.py``'s ``read(ctx)``, which returns
None where it finds nothing to read.
"""
from __future__ import annotations

import importlib
import importlib.util
import json
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "glomeruli_segmentation_tpu")


def manifest() -> dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def resolve(name: str, spec: dict = None):
    """(workload, configuration, traffic parameters) of cell ``name``."""
    spec = spec or manifest()
    found = [w for w in spec["workloads"] if w["name"] == name]
    if not found:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    workload = found[0]
    cfg = [c for c in spec["configs"] if c["name"] == workload["config"]][0]
    config = json.loads((ROOT / cfg["file"]).read_text())
    params = json.loads(
        (HERE / "traffic" / f"{workload['traffic']}.json").read_text())
    return workload, config, params


def applies(metric: dict, workload: str) -> bool:
    return "workloads" not in metric or workload in metric["workloads"]


def reader(name: str):
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"portbench.metrics.{name.replace('.', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def forbidden_modules(names=None) -> list:
    """Loaded modules (or ``names``) whose top-level name is JAX's or the
    JAX package's, compared whole."""
    names = list(sys.modules) if names is None else names
    return sorted({m.split(".")[0] for m in names} & set(FORBIDDEN))


def end_to_end(spec: dict, workload: str, values: dict) -> dict:
    out = {}
    for m in spec["end_to_end"]:
        if applies(m, workload):
            out[m["name"]] = {"value": values[m["name"]], "unit": m["unit"]}
    return out


def per_layer(spec: dict, workload: str, ctx: dict) -> dict:
    out = {}
    for m in spec["per_layer"]:
        if applies(m, workload):
            value = reader(m["name"])(ctx)
            if value is not None:
                out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def result(spec, workload, outcome, traced: bool, device: dict) -> dict:
    checks = outcome["checks"]
    correct = all(v <= limit for v, limit in checks.values())
    line = {"correct": bool(correct and outcome["failed"] == 0),
            "attempted": outcome["attempted"], "failed": outcome["failed"]}
    ctx = outcome["ctx"]
    if traced:
        line["metrics"] = per_layer(spec, workload, ctx)
        lo, hi = ctx["window_ns"]
        device = dict(device, busy_s=ctx["trace"].busy_s(lo, hi),
                      window_s=ctx["window_s"])
        line["device"] = device
        line["breakdown"] = {
            "device_ops": ctx["trace"].top_ops(lo, hi),
            "idle_gaps": ctx["trace"].idle_gaps(lo, hi, ctx["spans"])}
    else:
        line["metrics"] = end_to_end(spec, workload, outcome["end_to_end"])
        line["device"] = device
    line["compared"] = outcome["compared"]
    line["checks"] = {k: {"value": v, "limit": limit}
                      for k, (v, limit) in checks.items()}
    return line


def run(args, t_start: float) -> int:
    import torch

    if not torch.cuda.is_available():
        print("portbench: no CUDA device", file=sys.stderr)
        return 2
    spec = manifest()
    workload, config, params = resolve(args.workload, spec)
    if torch.cuda.device_count() < workload["chips"]:
        print(f"portbench: {workload['name']} needs {workload['chips']} "
              f"cards, {torch.cuda.device_count()} present", file=sys.stderr)
        return 2
    stage = importlib.import_module(f"portbench.stages.{params['stage']}")
    outcome = stage.run(workload, config, params, args.seed % 2**63,
                        args.seconds, bool(args.trace), t_start)
    bad = forbidden_modules()
    if bad:
        print(f"portbench: loaded {bad}, which the port must not use",
              file=sys.stderr)
        return 3
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": workload["chips"],
              "memory_peak_bytes": outcome["memory_peak_bytes"]}
    line = result(spec, workload["name"], outcome, bool(args.trace), device)
    for name, c in line["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0
