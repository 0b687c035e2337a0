"""The one traffic generator: slides with merged glomerulus boxes over
seeded pixels, from the parameters of a ``traffic/<name>.json`` file.

A run walks slides back to back, as ``gseg-e2e`` walks a folder (a closed
loop with one client).  The work is fixed by the file, not by the seed:
slides come in blocks of ``block_slides``, and every block holds the same
box counts (evenly spaced over ``boxes_per_slide``) and the same box
sides (evenly spaced over ``box_side_px``, widths and heights each).  The
seed decides only their order, the boxes' places on the slide and the
pixels, so two seeds ask for the same crops in another order.

Pixels come from one PAS-like atlas (a pink noisy background with dark
round glomerulus-like blobs) made on the device from the seed; a slide
reads the atlas tiled over its extent from an offset of its own.  Reads
return new RGB uint8 arrays, as a slide reader's do.
"""
from __future__ import annotations

import json
from pathlib import Path

import numpy as np

TRAFFIC_DIR = Path(__file__).resolve().parent / "traffic"


def load(name: str) -> dict:
    return json.loads((TRAFFIC_DIR / f"{name}.json").read_text())


def spread(lo: int, hi: int, n: int) -> np.ndarray:
    """``n`` whole numbers evenly spaced over [lo, hi], ends included."""
    if n == 1:
        return np.asarray([(lo + hi) // 2])
    return np.rint(np.linspace(lo, hi, n)).astype(np.int64)


def block_counts(params: dict) -> np.ndarray:
    lo, hi = params["boxes_per_slide"]
    return spread(lo, hi, params["block_slides"])


def block_sides(params: dict) -> np.ndarray:
    """The box sides of one block: stratified over ``box_side_px``."""
    lo, hi = params["box_side_px"]
    n = int(block_counts(params).sum())
    return np.rint(lo + (np.arange(n) + 0.5) * (hi - lo) / n).astype(
        np.int64)


class AtlasSlide:
    """A slide of ``dimensions`` (width, height) whose pixel (x, y) is the
    atlas's ((y + dy) mod A, (x + dx) mod A)."""

    def __init__(self, atlas: np.ndarray, width: int, height: int,
                 offset, boxes, on_read=None):
        self.atlas = atlas
        self.dimensions = (width, height)
        self.offset = offset
        self.boxes = boxes
        self.on_read = on_read

    def read_region_array(self, location, level, size):
        if level != 0:
            raise ValueError("AtlasSlide has level 0 only")
        if self.on_read is not None:
            with self.on_read():
                return self._read(location, size)
        return self._read(location, size)

    def _read(self, location, size):
        (x0, y0), (w, h) = location, size
        a_h, a_w = self.atlas.shape[:2]
        out = np.empty((h, w, 3), np.uint8)
        ys = (y0 + self.offset[0]) % a_h
        row = 0
        while row < h:
            rows = min(h - row, a_h - ys)
            xs = (x0 + self.offset[1]) % a_w
            col = 0
            while col < w:
                cols = min(w - col, a_w - xs)
                out[row: row + rows, col: col + cols] = \
                    self.atlas[ys: ys + rows, xs: xs + cols]
                col += cols
                xs = 0
            row += rows
            ys = 0
        return out


def make_atlas(params: dict, seed: int, device) -> np.ndarray:
    """The (A, A, 3) RGB uint8 atlas, made on ``device`` from ``seed`` in a
    few large calls and copied to the host once."""
    import torch

    a = params["atlas_px"]
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    noise = params["noise"]
    img = torch.randint(-noise, noise + 1, (a, a, 3), generator=gen,
                        device=device, dtype=torch.int16)
    img += torch.tensor(params["background_rgb"], dtype=torch.int16,
                        device=device)
    n = params["atlas_glomeruli"]
    r_lo, r_hi = params["glomerulus_radius_px"]
    centres = torch.randint(0, a, (n, 2), generator=gen, device=device)
    radii = torch.randint(r_lo, r_hi + 1, (n,), generator=gen,
                          device=device)
    coarse = torch.arange(a, device=device)
    outer, inner = (torch.tensor(c, dtype=torch.int16, device=device)
                    for c in params["glomerulus_rgb"])
    for (cy, cx), r in zip(centres.tolist(), radii.tolist()):
        y0, y1 = max(cy - r, 0), min(cy + r, a)
        x0, x1 = max(cx - r, 0), min(cx + r, a)
        d2 = ((coarse[y0:y1, None] - cy) ** 2
              + (coarse[None, x0:x1] - cx) ** 2)
        patch = img[y0:y1, x0:x1]
        patch[d2 < r * r] = outer
        patch[d2 < (r // 2) ** 2] = inner
    out = img.clamp(0, 255).to(torch.uint8).cpu().numpy()
    del img
    return out


class SlideStream:
    """The endless sequence of slides of one run: ``slide(i)`` is the i-th
    slide, the same for the same seed."""

    def __init__(self, params: dict, seed: int, atlas: np.ndarray,
                 on_read=None):
        self.params = params
        self.seed = seed
        self.atlas = atlas
        self.on_read = on_read
        self.counts = block_counts(params)
        self.sides = block_sides(params)
        self._blocks = {}

    def _block(self, b: int):
        """(per-slide box lists, per-slide offsets) of block ``b``."""
        if b not in self._blocks:
            h_px, w_px = self.params["slide_px"]
            rng = np.random.default_rng([self.seed, b])
            counts = rng.permutation(self.counts)
            ws = rng.permutation(self.sides)
            hs = rng.permutation(self.sides)
            slides, first = [], 0
            for n in counts:
                bw, bh = ws[first: first + n], hs[first: first + n]
                x1 = (rng.random(n) * (w_px - bw)).astype(np.int64)
                y1 = (rng.random(n) * (h_px - bh)).astype(np.int64)
                boxes = [[int(x), int(y), int(x + w), int(y + h), 0.9]
                         for x, y, w, h in zip(x1, y1, bw, bh)]
                offset = tuple(int(v) for v in rng.integers(
                    0, self.atlas.shape[0], 2))
                slides.append((boxes, offset))
                first += n
            self._blocks = {b: slides}  # one block is held at a time
        return self._blocks[b]

    def slide(self, i: int) -> AtlasSlide:
        per = self.params["block_slides"]
        boxes, offset = self._block(i // per)[i % per]
        h_px, w_px = self.params["slide_px"]
        return AtlasSlide(self.atlas, w_px, h_px, offset, boxes,
                          self.on_read)


def warmup_slides(params: dict, seed: int, atlas: np.ndarray):
    """The slides of set-up: one block of another stream, so every shape
    the window's slides use has been seen before it opens."""
    stream = SlideStream(params, seed ^ 0x5EED, atlas)
    return [stream.slide(i) for i in range(params["warmup_slides"])]
