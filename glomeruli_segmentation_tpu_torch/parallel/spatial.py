"""Spatial partitioning of one large tile over the devices of a mesh axis.

Counterpart of ``glomeruli_segmentation_tpu/parallel/spatial.py``: the
image is cut into horizontal stripes, one per device of the axis; each
device gets its stripe with ``overlap`` halo rows from each neighbour
(zeros beyond the image's top and bottom edges, as the JAX package's
``ppermute`` leaves them, matching a convolution's zero padding), runs the
network, and the stripes' centre rows are put back together.  The result
is exact wherever the network's receptive field fits inside the margin,
and approximate at the seams beyond it -- the overlap-tiling contract of
the reference's window detection and stitching.  Nothing on either
package's main path calls it.
"""
from __future__ import annotations

from typing import Callable

import torch

from .mesh import Mesh


def spatial_shard_forward(mesh: Mesh, fn: Callable, x: torch.Tensor,
                          overlap: int, axis_name: str = "data"
                          ) -> torch.Tensor:
    """Apply ``fn`` to ``x`` with its H axis spread over ``axis_name``.

    Args:
      fn: shift-invariant (N, h, W, C) -> (N, h, W, C') forward at the
          input's resolution (e.g. the full ESPNet, NHWC).
      x:  (N, H, W, C), H divisible by the axis size.
      overlap: halo rows taken from each neighbour, 0 < overlap <= H / n.
    Returns the assembled (N, H, W, C') output on the axis's first device.
    """
    devices = mesh.axis_devices(axis_name)
    n_dev = len(devices)
    x = torch.as_tensor(x)
    n, h, w, c = x.shape
    if h % n_dev:
        raise ValueError(f"height {h} does not split into {n_dev} stripes")
    stripe = h // n_dev
    if not 0 < overlap <= stripe:
        raise ValueError(f"overlap {overlap} outside (0, {stripe}]")
    zeros = x.new_zeros((n, overlap, w, c))
    outs = []
    for i, dev in enumerate(devices):
        top, bottom = i * stripe, (i + 1) * stripe
        above = x[:, top - overlap: top] if i > 0 else zeros
        below = x[:, bottom: bottom + overlap] if i < n_dev - 1 else zeros
        out = fn(torch.cat([above, x[:, top: bottom], below], dim=1).to(dev))
        outs.append(out[:, overlap: overlap + stripe].to(devices[0]))
    return torch.cat(outs, dim=1)
