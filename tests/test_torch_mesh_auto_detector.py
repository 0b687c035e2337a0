"""``--mesh auto`` and the detector's data axis in the port's ``gseg-e2e``
and ``gseg-serve`` (``cli/e2e.py`` ``resolve_mesh_policy`` and
``detector_data_parallel``, which ``cli/serve.py`` shares) on the CPU.

The detector's window batches get their own data axis, sized to divide
THEIR batch, and 0 (one device) when no size above 1 divides it: never
the segmenter's data axis.  Checked through both commands' parsers at the
two layouts where the segmenter's axis does not divide the detector's
batch of 1, over a sweep of device counts and batches, and by starting
both commands on N logical CPU devices with a small detector checkpoint,
so that ``load_backend`` builds the detector's mesh."""
import pytest
import torch

from glomeruli_segmentation_tpu_torch.cli import e2e as cli_e2e
from glomeruli_segmentation_tpu_torch.cli import serve as cli_serve
from glomeruli_segmentation_tpu_torch.convert.espnet_import import (
    random_state_dict,
)
from glomeruli_segmentation_tpu_torch.parallel.mesh import make_data_mesh

from test_torch_e2e_cli import _write_detector_ckpt
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

PARSERS = {"gseg-e2e": (cli_e2e, ["--target_list", "t", "--data_dir", "d"]),
           "gseg-serve": (cli_serve, ["--spool_dir", "s"])}
# (devices, extra flags, the segmenter's (fold, data) axes): the two
# layouts where the segmenter's data axis of 2 cannot split a window
# batch of 1
LAYOUTS = {"16 devices, 5 folds": (16, ["--batch_size", "1"], (8, 2)),
           "2 devices, 1 fold": (2, ["--batch_size", "1", "--folds", "1"],
                                 (0, 2))}


def _resolved(command, n, extra):
    module, inputs = PARSERS[command]
    args = module.build_parser().parse_args(["--model", "m", *inputs,
                                             *extra])
    cli_e2e.resolve_mesh_policy(args, n)
    return args


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
@pytest.mark.parametrize("command", sorted(PARSERS))
def test_detector_axis_divides_its_batch(command, layout, capsys):
    n, extra, seg_axes = LAYOUTS[layout]
    args = _resolved(command, n, extra)
    capsys.readouterr()
    assert (args.fold_parallel, args.data_parallel) == seg_axes
    assert args.detector_data_parallel == 0
    d = cli_e2e.detector_data_parallel(args)
    assert d == 0
    assert make_data_mesh(d, args.batch_size,
                          devices=[torch.device("cpu")] * n) is None
    # the segmenter's axis is the one that cannot split the window batch
    with pytest.raises(ValueError, match="must be a multiple of the "
                                         "data-axis size 2"):
        make_data_mesh(args.data_parallel, args.batch_size,
                       devices=[torch.device("cpu")] * n)


@pytest.mark.parametrize("n", [1, 2, 3, 4, 6, 8, 12, 16])
def test_detector_axis_divides_every_batch(n, capsys):
    """Every detector batch and fold count on ``n`` devices: the axis is 0
    or a divisor of the batch, at most ``n``, and its mesh builds."""
    for batch in (1, 2, 3, 4, 5, 6, 8, 12):
        for folds in (["1"], ["1", "2"], ["1", "2", "3", "4", "5"]):
            args = _resolved("gseg-e2e", n, ["--batch_size", str(batch),
                                             "--folds", *folds])
            d = cli_e2e.detector_data_parallel(args)
            assert d == 0 or (1 < d <= n and batch % d == 0), (batch, folds)
            mesh = make_data_mesh(d, batch,
                                  devices=[torch.device("cpu")] * n)
            assert (mesh is None) == (d == 0)
            if mesh is not None:
                assert batch % mesh.shape["data"] == 0
    capsys.readouterr()


def test_explicit_flags_keep_the_shared_axis():
    """Without the auto path (explicit flags, ``--mesh off``) the detector
    takes the shared ``--data_parallel``, as before."""
    for extra in (["--data_parallel", "2"],
                  ["--mesh", "off", "--data_parallel", "2"]):
        args = _resolved("gseg-e2e", 4, extra)
        assert not hasattr(args, "detector_data_parallel")
        assert cli_e2e.detector_data_parallel(args) == 2


@pytest.fixture(scope="module")
def model_dirs(tmp_path_factory):
    """A small ``detector.ckpt.pth`` and five fold checkpoints (p=1,
    q=2)."""
    root = tmp_path_factory.mktemp("mesh_auto")
    (root / "model").mkdir()
    _write_detector_ckpt(root / "model" / "detector.ckpt.pth")
    (root / "weights").mkdir()
    for fold in range(1, 6):
        torch.save(random_state_dict(fold, 5, p=1, q=2),
                   root / "weights" / f"espnet_fold{fold}.pth")
    (root / "targets.txt").write_text("")
    return root


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
@pytest.mark.parametrize("command", sorted(PARSERS))
def test_commands_start(model_dirs, tmp_path, command, layout, capsys):
    """Each command starts under ``--mesh auto``: the detector loads with
    its own axis (none here), the segmenter's fold x data mesh builds, and
    the command ends with no slide to run."""
    n, extra, (fold, data) = LAYOUTS[layout]
    argv = ["--model", str(model_dirs / "model"),
            "--segmentation_weights_dir", str(model_dirs / "weights"),
            "--output_dir", str(tmp_path / "out"), "--seg_batch_size", "2",
            *extra]
    devices = [torch.device("cpu")] * n
    if command == "gseg-e2e":
        cli_e2e.main(argv + ["--target_list", str(model_dirs / "targets.txt"),
                             "--data_dir", str(tmp_path)],
                     device="cpu", devices=devices)
    else:
        cli_serve.main(argv + ["--spool_dir", str(tmp_path / "spool"),
                               "--max_slides", "0"],
                       device="cpu", devices=devices)
    out = capsys.readouterr().out
    want = (f"fold x data = {fold} x {data}" if fold
            else f"data parallel x {data}")
    assert f"--mesh auto: {n} devices -> {want}" in out
