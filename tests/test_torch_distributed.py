"""The port's ``parallel/distributed.py`` on its own, on the CPU.

- ``shard_rows`` gives each rank the rows ``jax.device_put`` gives each
  device of a 2-device ``P("data")`` sharding on the suite's CPU mesh, and
  refuses a batch that does not split.
- Two gloo ranks (spawned processes, as ``--data_parallel 2 --device cpu``
  starts them): ``AllReduceSum``'s gradient equals the one-process
  gradient of the summed loss; a file rank 0 writes after the other rank
  reached ``barrier`` is there when the barrier lets it go; ``is_primary``
  on rank 0 only; ``init_distributed`` inside a rank returns the rank's
  plan whatever it is given; ``gather_rows``, ``global_ratio``'s share
  and value, and ``reduce_gradients`` against one process's sums.
- The rank plans: ``GSEG_*`` fallbacks, explicit flags over them, ``-1``,
  and the sizes that do not split; the backend rule as a pure function;
  outside a rank every piece is the one-device identity and planning
  touches no CUDA.
- ``ops/_build.py``: three processes building one kernel at once run
  ``nvcc`` once (a fake one on the ``PATH``)."""
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

import torch_rank_steps
from torch_threads import one_torch_thread  # noqa: F401

from glomeruli_segmentation_tpu_torch.parallel import distributed

CPU = torch.device("cpu")


def test_shard_rows_equals_jax_sharding():
    x = np.arange(8 * 3 * 2, dtype=np.float32).reshape(8, 3, 2)
    mesh = Mesh(np.array(jax.devices()[:2]), ("data",))
    arr = jax.device_put(x, NamedSharding(mesh, P("data")))
    shards = sorted(arr.addressable_shards, key=lambda s: s.index[0].start)
    for r, shard in enumerate(shards):
        np.testing.assert_array_equal(distributed.shard_rows(x, r, 2),
                                      np.asarray(shard.data))
    with pytest.raises(ValueError, match="does not split"):
        distributed.shard_rows(x[:3], 0, 2)


@pytest.fixture(scope="module")
def probed(tmp_path_factory):
    rng = np.random.RandomState(0)
    xs = rng.randn(2, 5)
    weights = rng.randn(2, 5)
    rows = rng.randn(4, 3).astype(np.float32)
    path = tmp_path_factory.mktemp("probe") / "handoff.txt"
    plan = distributed.plan_ranks(2, device="cpu")
    assert distributed.launch(plan, torch_rank_steps.probe, xs, weights,
                              rows, str(path)) is None
    return xs, weights, rows, distributed.last_reports


def test_all_reduce_sum_gradient_equals_one_process(probed):
    xs, weights, _, reports = probed
    x = torch.tensor(xs, requires_grad=True)
    s = (x * x).sum(0)
    (torch.tensor(weights) * torch.tanh(s)).sum().backward()
    for r, rep in enumerate(reports):
        assert rep["rank"] == r
        np.testing.assert_allclose(rep["grad"], x.grad[r].numpy(),
                                   rtol=1e-12)


def test_barrier_primary_and_idempotence(probed):
    reports = probed[3]
    assert [rep["seen"] for rep in reports] == ["written by rank 0"] * 2
    assert [rep["primary"] for rep in reports] == [True, False]
    assert [rep["world"] for rep in reports] == [2, 2]
    assert all(rep["same_plan"] for rep in reports)
    assert [rep["device"] for rep in reports] == ["cpu", "cpu"]


def test_gather_ratio_and_gradients_equal_one_process(probed):
    _, _, rows, reports = probed
    want = np.concatenate([np.full((2, 3), 1.0), np.full((2, 3), 2.0)])
    torch.manual_seed(0)
    layer = torch.nn.Linear(3, 1)
    (layer(torch.from_numpy(rows)) ** 2).sum().backward()
    for r, rep in enumerate(reports):
        np.testing.assert_array_equal(rep["gathered"], want)
        # numerators 1 and 2 over denominators 4 and 8: the share is the
        # rank's numerator over 12, the value 3 / 12 on both ranks
        assert rep["share"] == pytest.approx((r + 1) / 12)
        assert rep["value"] == pytest.approx(0.25)
        assert rep["num_grad"] == pytest.approx(1 / 12)
        np.testing.assert_array_equal(rep["rows"], rows[2 * r:2 * r + 2])
        for k, p in layer.named_parameters():
            np.testing.assert_allclose(rep["layer_grads"][k],
                                       p.grad.numpy(), rtol=1e-6, atol=1e-6)


def test_backend_rule():
    assert distributed.backend_for(["cpu", "cpu"]) == "gloo"
    assert distributed.backend_for(["cuda:0", "cuda:0"]) == "gloo"
    assert distributed.backend_for(["cuda:0", "cuda:1"]) == "nccl"
    assert distributed.backend_for(["cuda:0"]) == "nccl"
    assert distributed.backend_for(["cuda:0", "cpu"]) == "gloo"


def test_plans_env_fallbacks_and_sizes(monkeypatch):
    monkeypatch.setenv("GSEG_COORDINATOR", "10.0.0.1:2345")
    monkeypatch.setenv("GSEG_NUM_PROCESSES", "2")
    monkeypatch.setenv("GSEG_PROCESS_ID", "1")
    plan = distributed.init_distributed(data_parallel=4, device="cpu")
    assert (plan.world, plan.local, plan.first, plan.address,
            plan.backend) == (4, 2, 2, "10.0.0.1:2345", "gloo")
    assert plan.devices == (CPU, CPU)
    # flags over the environment
    plan = distributed.init_distributed("h:7", 4, 0, data_parallel=4,
                                        device="cpu")
    assert (plan.world, plan.local, plan.first, plan.address) == \
        (4, 1, 0, "h:7")
    with pytest.raises(ValueError, match="must split evenly"):
        distributed.init_distributed(data_parallel=3, device="cpu")
    with pytest.raises(ValueError, match="process_id 2 is not in"):
        distributed.init_distributed(process_id=2, data_parallel=2,
                                     device="cpu")
    # -1: every device of the list, in every process
    plan = distributed.init_distributed(
        data_parallel=-1, device="cpu", devices=["cpu"] * 3)
    assert (plan.world, plan.local, plan.first) == (6, 3, 3)
    monkeypatch.delenv("GSEG_COORDINATOR")
    monkeypatch.delenv("GSEG_NUM_PROCESSES")
    monkeypatch.delenv("GSEG_PROCESS_ID")
    with pytest.raises(ValueError, match="requested a 3-device mesh"):
        distributed.plan_ranks(3, device="cuda", devices=["cuda:0"] * 2)
    plan = distributed.plan_ranks(2, devices=["cuda:0", "cuda:0"])
    assert plan.backend == "gloo" and plan.address.startswith("127.0.0.1:")


def test_outside_a_rank_is_one_device(monkeypatch):
    def no_cuda(*a, **k):
        raise AssertionError("touched CUDA")

    monkeypatch.setattr(torch.cuda, "device_count", no_cuda)
    monkeypatch.setattr(torch.cuda, "is_available", no_cuda)
    assert distributed.init_distributed() is None
    assert distributed.init_distributed(process_id=1) is None
    assert not distributed.joined()
    assert distributed.is_primary() and distributed.world() == 1
    assert distributed.rank_device() is None
    distributed.barrier("nothing to wait for")
    t = torch.arange(6.0).reshape(3, 2)
    assert distributed.gather_rows(t) is t
    np.testing.assert_array_equal(distributed.shard_rows(t.numpy()), t)
    share, value = distributed.global_ratio(torch.tensor(3.0),
                                            torch.tensor(0.0), floor=1)
    assert float(share) == float(value) == 3.0
    distributed.report(ignored=True)
    layer = torch.nn.Linear(2, 1)
    layer(t).sum().backward()
    before = layer.weight.grad.clone()
    distributed.reduce_gradients(layer)
    assert torch.equal(layer.weight.grad, before)


BUILDER = r"""
import sys
from pathlib import Path
from glomeruli_segmentation_tpu_torch.ops import _build
_build.BUILD_DIR = Path(sys.argv[1])
_build.build(["nms"])
print(_build.library_path("nms").is_file(), "nms" in _build.build_log)
"""

FAKE_NVCC = r"""#!{python}
import sys, time
out = sys.argv[sys.argv.index("-o") + 1]
with open({log!r}, "a") as f:
    f.write(out + "\n")
time.sleep(0.5)
open(out, "w").write("built")
"""


def test_ranks_of_a_host_build_a_kernel_once(tmp_path):
    """Concurrent builders (the ranks of one host) wait on the build lock:
    one runs ``nvcc``, the others find its library; a fake ``nvcc`` on the
    ``PATH`` logs each call."""
    log = tmp_path / "nvcc.log"
    nvcc = tmp_path / "bin" / "nvcc"
    nvcc.parent.mkdir()
    nvcc.write_text(FAKE_NVCC.format(python=sys.executable, log=str(log)))
    nvcc.chmod(0o755)
    env = dict(os.environ,
               PATH=os.pathsep.join((str(nvcc.parent), os.environ["PATH"])),
               PYTHONPATH=os.pathsep.join(
                   p for p in (str(Path(__file__).resolve().parents[1]),
                               os.environ.get("PYTHONPATH")) if p))
    procs = [subprocess.Popen([sys.executable, "-c", BUILDER,
                               str(tmp_path / "build")], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for _ in range(3)]
    outs = [p.communicate(timeout=120) for p in procs]
    assert all(p.returncode == 0 for p in procs), outs
    assert len(log.read_text().splitlines()) == 1
    # every builder loads the library; one of them built it
    assert sorted(o.split()[1] for o, _ in outs) == ["False", "False",
                                                     "True"]
    assert all(o.split()[0] == "True" for o, _ in outs)
    assert not list((tmp_path / "build").glob("*.tmp"))
