"""The comparison that decides ``correct`` for a slide canvas.

The program returns a /8 canvas whose pixels are class ids, each the
largest of the classes that the crops covering it chose there (the
max-paste of both slide segmenters).  The reference gives, for every crop,
its scores per class at the same /8 pixels.  A crop's gap for class ``c``
is how far the reference's score of ``c`` lies below its best there:
``g(c) = max S - S[c]``.

The number compared is the widest gap by which the reference has to be
moved to give the program's canvas: at a pixel the program labelled
``v``, every covering crop must have chosen at most ``v`` (for a crop,
``h(v) = min over c <= v of g(c)``) and one of them exactly ``v``
(``g(v)``), so the pixel's gap is ``max(max over crops of h(v), min over
crops of g(v))``; 0 where the program chose what the reference does.
A labelled pixel that no crop covers is a stray, and must not occur.
The share of the compared pixels whose gap is above 0 is the mismatch
share.  A configuration names which of the two numbers it holds to a
limit.
"""
from __future__ import annotations

import numpy as np
import torch


class CanvasCheck:
    def __init__(self, canvas: np.ndarray, classes: int, device):
        self.classes = classes
        self.v = torch.from_numpy(np.ascontiguousarray(canvas)).to(
            device).long()
        self.h = torch.zeros(self.v.shape, dtype=torch.float64,
                             device=device)
        self.g = torch.full(self.v.shape, float("inf"), dtype=torch.float64,
                            device=device)
        self.covered = torch.zeros(self.v.shape, dtype=torch.bool,
                                   device=device)

    def add(self, box, scores: torch.Tensor) -> None:
        """``scores``: (classes, (y2 - y1) // 8, (x2 - x1) // 8), the
        reference's scores of the crop of ``box`` at its /8 pixels."""
        x1, y1 = int(box[0]), int(box[1])
        y0, x0 = y1 // 8, x1 // 8
        ch = max(0, min(scores.shape[1], self.v.shape[0] - y0))
        cw = max(0, min(scores.shape[2], self.v.shape[1] - x0))
        if ch == 0 or cw == 0:
            return
        s = scores[:, :ch, :cw].to(self.h.device, torch.float64)
        v = self.v[y0: y0 + ch, x0: x0 + cw]
        bad = v >= self.classes
        idx = v.clamp_max(self.classes - 1)[None]
        best = s.max(0).values
        g = best - s.gather(0, idx)[0]
        h = best - s.cummax(0).values.gather(0, idx)[0]
        inf = torch.tensor(float("inf"), dtype=torch.float64,
                           device=s.device)
        g = torch.where(bad, inf, g)
        h = torch.where(bad, inf, h)
        region = (slice(y0, y0 + ch), slice(x0, x0 + cw))
        self.h[region] = torch.maximum(self.h[region], h)
        self.g[region] = torch.minimum(self.g[region], g)
        self.covered[region] = True

    def result(self) -> dict:
        gap = torch.maximum(self.h, self.g)[self.covered]
        stray = (~self.covered) & (self.v != 0)
        # a label no crop can give reads as a gap too wide to pass
        return {"gap": min(float(gap.max()), 1e300) if gap.numel() else 0.0,
                "mismatched": int((gap > 0).sum()),
                "stray": int(stray.sum()),
                "pixels": int(self.covered.sum())}


def merge(results) -> dict:
    """Several slides' results as one: the widest gap, and the sums of the
    mismatched pixels, the strays and the pixels compared."""
    results = list(results)
    out = {"gap": max((r["gap"] for r in results), default=0.0)}
    for key in ("mismatched", "stray", "pixels"):
        out[key] = sum(r[key] for r in results)
    return out


def numbers(got: dict) -> dict:
    """The numbers a limit can be set on: the widest gap, and the share of
    the compared pixels whose label the reference would not give."""
    return {"canvas_gap": got["gap"],
            "mismatch_share": got["mismatched"] / max(got["pixels"], 1)}
