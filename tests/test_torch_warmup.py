"""The port's warm-up (``cli/warmup.py``) against the JAX package's on the
CPU: the same flags and defaults, the same segmenter and detector calls
in the same order at the same shapes, the same ``warmed:`` line, and the
flags that are not ported."""
import numpy as np
import pytest
import torch

from glomeruli_segmentation_tpu.cli import detect as jax_cli_detect
from glomeruli_segmentation_tpu.cli import warmup as jax_warmup
from glomeruli_segmentation_tpu.pipeline import fused as jax_fused
from glomeruli_segmentation_tpu_torch.cli import detect as cli_detect
from glomeruli_segmentation_tpu_torch.cli import warmup
from glomeruli_segmentation_tpu_torch.convert.espnet_import import (
    random_state_dict,
)
from glomeruli_segmentation_tpu_torch.pipeline import fused as port_fused

from test_torch_e2e_cli import _write_detector_ckpt
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

ENSEMBLE_CALLS = ("segment_batch_padded", "segment_batch_gather",
                  "submit_batch_flat", "submit_batch_gather_flat")


def _shapes(args):
    return tuple(np.shape(a) if isinstance(a, np.ndarray) else a
                 for a in args)


def test_parser_matches_jax():
    def options(parser):
        return [(a.option_strings, a.dest, a.default, a.nargs, a.choices)
                for a in parser._actions]

    assert options(warmup.build_parser()) == \
        options(jax_warmup.build_parser())


@pytest.fixture(scope="module")
def layout(tmp_path_factory):
    """A fold-1 checkpoint (p=1, q=2) and a model dir holding the tiny
    ResNet detector's ``detector.ckpt.pth``."""
    root = tmp_path_factory.mktemp("warmup")
    (root / "weights").mkdir()
    torch.save(random_state_dict(1, 5, p=1, q=2),
               root / "weights" / "espnet_fold1.pth")
    (root / "model").mkdir()
    _write_detector_ckpt(root / "model" / "detector.ckpt.pth")
    return root


def _jax_calls(monkeypatch, argv):
    """The JAX command's segmenter and detector calls for ``argv``, with
    both stubbed (its ensemble has no p=1, q=2 form and would compile the
    full network)."""
    calls = []

    class Ensemble:
        def __init__(self, config, engine):
            calls.append(("ensemble", tuple(config.folds), config.batch_size,
                          engine))

        def __getattr__(self, name):
            def record(*args):
                calls.append((name, _shapes(args)))
                return np.zeros(1, np.uint8)
            return record

    class Backend:
        def detect_batch(self, images):
            calls.append(("detect_batch", images.shape))

    def load_backend(model, model_name, batch_size, od_api_overrides):
        calls.append(("load_backend", model_name, batch_size,
                      od_api_overrides))
        return Backend()

    monkeypatch.setattr(jax_fused, "EnsembleSegmenter", Ensemble)
    monkeypatch.setattr(jax_cli_detect, "load_backend", load_backend)
    jax_warmup.main(argv)
    return calls


def test_main_makes_the_jax_calls(layout, monkeypatch, capsys):
    argv = ["--segmentation_weights_dir", str(layout / "weights"),
            "--folds", "1", "--seg_batch_size", "2", "--buckets", "256",
            "--flat_eighths", "5", "9", "--model", str(layout / "model"),
            "--window_sizes", "128", "--batch_size", "4"]
    with monkeypatch.context() as m:
        want = _jax_calls(m, argv)
        want_lines = capsys.readouterr().out.splitlines()

    got = []
    for name in ENSEMBLE_CALLS:
        orig = getattr(port_fused.EnsembleSegmenter, name)

        def record(self, *args, _name=name, _orig=orig):
            got.append((_name, _shapes(args)))
            return _orig(self, *args)
        monkeypatch.setattr(port_fused.EnsembleSegmenter, name, record)
    init = port_fused.EnsembleSegmenter.__init__

    def record_init(self, config, engine, device):
        got.append(("ensemble", tuple(config.folds), config.batch_size,
                    engine))
        init(self, config, engine=engine, device=device)
    monkeypatch.setattr(port_fused.EnsembleSegmenter, "__init__",
                        record_init)
    load = cli_detect.load_backend

    def load_backend(model, model_name, batch_size, od_api_overrides,
                     device):
        got.append(("load_backend", model_name, batch_size,
                    od_api_overrides))
        backend = load(model, model_name, batch_size, od_api_overrides,
                       device=device)
        detect = backend.detect_batch
        backend.detect_batch = lambda images: (
            got.append(("detect_batch", images.shape)), detect(images))[1]
        return backend
    monkeypatch.setattr(cli_detect, "load_backend", load_backend)

    warmup.main(argv, device="cpu")
    lines = capsys.readouterr().out.splitlines()
    assert got == want
    assert [c[0] for c in got].count("submit_batch_flat") == 2
    assert lines == want_lines
    assert lines[-1] == ("warmed: ensemble@256, ensemble@256:flat5/8, "
                         "ensemble@256:flat9/8, detector@128")


@pytest.mark.parametrize("argv,message", [
    (["--engine", "xla"], "nothing to warm"),
    (["--pack_output"], "nothing to warm"),
    ([], "nothing to warm"),
    (["--window_sizes", "128", "--buckets"], "nothing to warm"),
])
def test_unported_and_nothing_to_warm_exit(argv, message):
    """Without weights or a model there is nothing to warm, in both
    packages, whatever the engine and readback flags."""
    with pytest.raises(SystemExit, match=message):
        warmup.main(argv, device="cpu")
    with pytest.raises(SystemExit, match=message):
        jax_warmup.main(argv)


def test_xla_engine_and_pack_output_warm(layout, capsys):
    """``--engine xla --pack_output`` warms the plain fold engine with the
    packed full-resolution readback, as the JAX command does."""
    warmup.main(["--segmentation_weights_dir", str(layout / "weights"),
                 "--folds", "1", "--seg_batch_size", "2", "--buckets", "256",
                 "--flat_eighths", "5", "--engine", "xla", "--pack_output"],
                device="cpu")
    assert capsys.readouterr().out.splitlines()[-1] == (
        "warmed: ensemble@256, ensemble@256:flat5/8")


def test_main_runs_on_cuda_by_default(monkeypatch):
    """Without ``device`` the warm-up asks for the card before it builds or
    loads anything, and raises where there is none."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        warmup.main(["--model", "/nowhere"])
