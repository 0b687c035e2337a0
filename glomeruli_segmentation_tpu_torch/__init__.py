"""PyTorch/CUDA port of glomeruli_segmentation_tpu for NVIDIA Hopper GPUs.

Module names mirror the JAX package, so each module's counterpart is found
by name.  Entry points run on ``device="cuda"`` unless the caller passes
``device="cpu"``; on the CPU every kernel wrapper runs its plain PyTorch
version.
"""
import torch


def resolve_device(device="cuda") -> torch.device:
    """``device`` as a ``torch.device``; raise if it names CUDA and no card
    is present (the port never falls back to the CPU on its own)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU")
    return dev
