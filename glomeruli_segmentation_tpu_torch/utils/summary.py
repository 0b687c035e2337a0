"""Model structure summary.

Equivalent of the reference's graphviz autograd rendering
(``VisualizeGraph.make_dot`` at ``main.py:236-244``; optional per
SURVEY.md §2.4 — a structured summary is the documented acceptable
replacement): a per-module parameter table written to ``model.txt``.

The port's copy of ``glomeruli_segmentation_tpu/utils/summary.py``; it
walks any nested dict of arrays or tensors (``np.shape`` of each leaf).
"""
from __future__ import annotations

from typing import Any, Dict, List, Tuple

import numpy as np


def _walk(tree: Dict, prefix: Tuple[str, ...] = ()):
    for key, value in tree.items():
        if isinstance(value, dict):
            yield from _walk(value, prefix + (key,))
        else:
            yield prefix + (key,), value


def model_summary(params: Dict[str, Any]) -> str:
    lines: List[str] = []
    total = 0
    module_totals: Dict[str, int] = {}
    for path, leaf in _walk(params):
        n = int(np.prod(np.shape(leaf)))
        total += n
        lines.append("{:<70} {:<18} {:>10}".format(
            "/".join(path), str(tuple(np.shape(leaf))), n))
        module_totals.setdefault(path[0], 0)
        module_totals[path[0]] += n
    out = ["{:<70} {:<18} {:>10}".format("parameter", "shape", "count"),
           "-" * 100]
    out += lines
    out += ["-" * 100]
    for mod, count in module_totals.items():
        out.append("{:<70} {:>28}".format(mod, count))
    out += ["-" * 100, f"total parameters: {total}"]
    return "\n".join(out)
