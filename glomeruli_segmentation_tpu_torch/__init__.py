"""PyTorch/CUDA port of glomeruli_segmentation_tpu for NVIDIA Hopper GPUs.

Module names mirror the JAX package, so each module's counterpart is found
by name.  Entry points run on ``device="cuda"`` unless the caller passes
``device="cpu"``; on the CPU every kernel wrapper runs its plain PyTorch
version.
"""
import contextlib
import threading

import numpy as np
import torch


def resolve_device(device="cuda") -> torch.device:
    """``device`` as a ``torch.device``; raise if it names CUDA and no card
    is present (the port never falls back to the CPU on its own)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU")
    return dev


def readback(out: torch.Tensor):
    """A handle on the host copy of ``out``, read with :func:`read_host`.
    On a card the copy into pinned host memory is enqueued right behind the
    kernels that make ``out``, with an event after it, so the read waits for
    those kernels only, not for work launched after them (the next batch,
    or another thread's on the same stream).  On the CPU the handle is
    ``out``."""
    if out.device.type != "cuda":
        return out
    host = torch.empty(out.shape, dtype=out.dtype, pin_memory=True)
    host.copy_(out, non_blocking=True)
    done = torch.cuda.Event()
    done.record()
    return host, done


def read_host(handle) -> np.ndarray:
    """A :func:`readback` handle as a numpy array; a list of handles (the
    shards of a batch over a mesh's data axis) as their concatenation."""
    if isinstance(handle, list):
        parts = [read_host(h) for h in handle]
        return parts[0] if len(parts) == 1 else np.concatenate(parts)
    if isinstance(handle, tuple):
        host, done = handle
        done.synchronize()
        return host.numpy()
    return handle.numpy()


# The TF32 switches are process-global and read when an op is dispatched.
# Every forward of the port sets them under this lock, so the detector and
# the segmenter, which dispatch from two threads in a pipelined run, never
# run an op under the other's settings.
_TF32_LOCK = threading.RLock()


@contextlib.contextmanager
def tf32(cudnn: bool, matmul: bool):
    """Hold ``torch.backends.cudnn.allow_tf32`` at ``cudnn`` and
    ``torch.backends.cuda.matmul.allow_tf32`` at ``matmul`` for the host
    dispatch of one forward, then restore both.  The device work is only
    enqueued inside, so it still overlaps other threads' work."""
    with _TF32_LOCK:
        saved = (torch.backends.cudnn.allow_tf32,
                 torch.backends.cuda.matmul.allow_tf32)
        torch.backends.cudnn.allow_tf32 = cudnn
        torch.backends.cuda.matmul.allow_tf32 = matmul
        try:
            yield
        finally:
            (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32) = saved
