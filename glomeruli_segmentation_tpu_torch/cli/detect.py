"""Detector model loading for the port's CLIs.

Counterpart of ``glomeruli_segmentation_tpu/cli/detect.py``.  Only
:func:`load_backend` is ported so far, with the JAX package's precedence
and errors; the ``gseg-detect`` entry point (``main``, with the slide loop
``split_all``/``split`` and ``resume``) comes with the CLI slice.
"""
import os


def load_backend(model_dir: str, model_name: str = None, batch_size: int = 8,
                 od_api_overrides=None, data_parallel: int = 0,
                 device="cuda"):
    """Resolve a detector backend from ``model_dir``.

    ``model_name=None`` auto-discovers in precedence order native checkpoint
    (``detector.ckpt.pth``) > fine-tuned OD-API checkpoint
    (``od_api_detector.ckpt.pth``) > ``frozen_inference_graph.pb``.  An
    explicit ``model_name`` loads exactly that file (dispatch by basename),
    so a fine-tuned checkpoint written next to the downloaded ``.pb`` cannot
    silently preempt an explicitly requested graph.  ``data_parallel``
    other than 0 raises: the window mesh is not ported."""
    if data_parallel:
        raise SystemExit(f"data_parallel={data_parallel}: the data-parallel "
                         "detector mesh is not ported")
    explicit = model_name is not None
    if explicit:
        requested = os.path.join(model_dir, model_name)
        if not os.path.isfile(requested):
            raise SystemExit(f"--model_name: {requested} not found")
        base = os.path.basename(model_name)
        native_ok = base == "detector.ckpt.pth"
        od_ok = base == "od_api_detector.ckpt.pth"
        pb_ok = not (native_ok or od_ok)
    else:
        native_ok = od_ok = pb_ok = True
        model_name = "frozen_inference_graph.pb"

    # an explicit name loads exactly the file named -- including when it
    # lives in a subdirectory of model_dir (dispatch is by basename only)
    native_ckpt = (requested if explicit
                   else os.path.join(model_dir, "detector.ckpt.pth"))
    if native_ok and os.path.isfile(native_ckpt):
        from ..convert.detector_import import load_detector_checkpoint
        from ..pipeline.detect import TorchDetectorBackend

        state, config = load_detector_checkpoint(native_ckpt)
        return TorchDetectorBackend(state, config, batch_size, device=device)

    od_ckpt = (requested if explicit
               else os.path.join(model_dir, "od_api_detector.ckpt.pth"))
    if od_ok and os.path.isfile(od_ckpt):
        # natively fine-tuned OD-API weights; architecture constants saved
        # at training time are defaults, CLI overrides win
        from ..convert.pb_import import load_od_api_checkpoint
        from ..pipeline.detect import ODAPIDetectorBackend

        params, num_classes, saved = load_od_api_checkpoint(od_ckpt)
        arch_keys = ("stride", "anchor_scales", "anchor_aspects",
                     "anchor_base", "initial_crop_size")
        merged = {k: tuple(v) if isinstance(v, list) else v
                  for k, v in saved.items() if k in arch_keys}
        merged.update(od_api_overrides or {})
        return ODAPIDetectorBackend(params=params, num_classes=num_classes,
                                    batch_size=batch_size, device=device,
                                    **merged)

    pb_path = os.path.join(model_dir, model_name)
    if pb_ok and os.path.isfile(pb_path):
        # the reference's downloaded OD-API export: constants are extracted
        # and assembled into the native inception_v2 Faster R-CNN
        from ..convert.pb_import import UnmappedWeightsError
        from ..pipeline.detect import ODAPIDetectorBackend

        try:
            return ODAPIDetectorBackend(pb_path, batch_size, device=device,
                                        **(od_api_overrides or {}))
        except UnmappedWeightsError as e:
            raise SystemExit(
                f"{pb_path}: not an OD-API inception_v2 Faster R-CNN "
                f"export ({e}); train/convert a native detector checkpoint "
                "(detector.ckpt.pth) instead")
    raise SystemExit(f"no detector model found in {model_dir}")
