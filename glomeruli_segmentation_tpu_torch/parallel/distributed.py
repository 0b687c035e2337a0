"""Data-parallel training over ranks on ``torch.distributed``.

Counterpart of ``glomeruli_segmentation_tpu/parallel/distributed.py``.
There, ``--data_parallel N`` jits a trainer's step with the batch sharded
over an N-device data axis and the state replicated, and GSPMD partitions
the one-device step on the global batch; ``--coordinator``,
``--num_processes`` and ``--process_id`` (or ``GSEG_COORDINATOR``,
``GSEG_NUM_PROCESSES``, ``GSEG_PROCESS_ID``) span that axis over
processes.  Here the data axis is a world of ranks, one process per
device, and the trainers compute the same function as that step:

- every rank builds the same seeded state and the same batches, pads a
  ragged batch to a multiple of the world as the JAX trainers do, and keeps
  its contiguous block of rows (:func:`shard_rows`, the ``P("data")``
  layout of ``put_global``);
- BatchNorm's training statistics, the losses' numerators and denominators
  and the metric histograms are sums over the world (:class:`AllReduceSum`
  where a gradient flows through them, :func:`all_reduce_sum` where none
  does); each rank backpropagates its share of the global loss, and
  :func:`reduce_gradients` sums the shares' gradients before the optimizer
  steps, so every rank applies the gradient of the global loss;
- rank 0 writes the artifacts (:func:`is_primary`), and file handoffs wait
  at :func:`barrier`, a rendezvous on the ranks' TCP store.

Launching: ``--data_parallel N`` without a coordinator starts N local
ranks (spawned processes) on the first N devices of the port's mesh list
(``parallel/mesh.py``: the visible cards, or an explicit ``devices=`` list,
which may name one card twice); under ``--device cpu`` every rank runs on
the CPU.  ``-1`` takes every device.  With a coordinator ``host:port`` and
P processes, process p starts its N / P local ranks, numbered p k to
p k + k - 1, and global rank 0 serves the store at the coordinator.  The
backend follows a rule (:func:`backend_for`): ``nccl`` where the ranks of a
host each own a different card, ``gloo`` where they share a card or run on
the CPU.  The launching call returns what rank 0 returned; what each rank
put in :func:`report` lands in :data:`last_reports`.

The JAX module's ``compile_aligned`` and ``host_replicated`` have no
counterpart: the port compiles nothing per shape (its one first-use build,
``nvcc`` of the NMS kernel, is serialised per host by ``ops/_build.py``'s
lock), and every rank builds the same seeded state, so there is nothing to
replicate.
"""
from __future__ import annotations

import datetime
import os
import socket
from typing import Any, Callable, Dict, List, NamedTuple, Optional, Sequence

import torch
import torch.distributed as dist


class RankPlan(NamedTuple):
    """The ranks of one data axis, as one process starts them."""
    world: int                    # ranks over every process
    first: int                    # global rank of this process's first one
    devices: tuple                # one torch.device per local rank
    backend: str                  # "nccl" or "gloo"
    address: str                  # host:port of global rank 0's store
    threads: int                  # torch intra-op threads per local rank

    @property
    def local(self) -> int:
        return len(self.devices)


class _Joined(NamedTuple):
    plan: RankPlan
    rank: int
    device: torch.device
    store: Any


_joined: Optional[_Joined] = None
_barrier_uses: Dict[str, int] = {}
_report: Dict[str, Any] = {}
# what each local rank of the last launch put in report(), in rank order
last_reports: List[Dict[str, Any]] = []


def backend_for(devices: Sequence) -> str:
    """``nccl`` when every rank of the host owns a card of its own,
    ``gloo`` when ranks share a card or run on the CPU."""
    devices = [torch.device(d) for d in devices]
    if all(d.type == "cuda" for d in devices) and \
            len({d.index for d in devices}) == len(devices):
        return "nccl"
    return "gloo"


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def plan_ranks(data_parallel: int, coordinator: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None, device="cuda",
               devices=None) -> Optional[RankPlan]:
    """The ranks ``--data_parallel`` and the coordinator flags ask for, or
    None for the one-device run (``0`` and no coordinator).  ``N`` ranks in
    all (``-1``: every device of every process), split evenly over the
    processes; with a coordinator and ``0``, one rank per process."""
    from .mesh import make_mesh

    data_parallel = int(data_parallel or 0)
    if not data_parallel and coordinator is None:
        return None
    n_proc = int(num_processes or 1)
    pid = int(process_id or 0)
    if not 0 <= pid < n_proc:
        raise ValueError(f"--process_id {pid} is not in [0, {n_proc})")
    if data_parallel < 0:
        local = None
    elif data_parallel == 0:
        local = 1
    else:
        if data_parallel % n_proc:
            raise ValueError(
                f"--data_parallel {data_parallel} must split evenly over "
                f"--num_processes {n_proc}: each process starts "
                "data_parallel / num_processes ranks")
        local = data_parallel // n_proc
    if devices is None and torch.device(device).type == "cpu":
        devices = ["cpu"] * (local or 1)
    if devices is not None:
        devices = [torch.device(d) for d in devices]
    rank_devices = tuple(make_mesh(local, devices=devices)
                         .axis_devices("data"))
    if coordinator is None:
        address = f"127.0.0.1:{_free_port()}"
    else:
        address = coordinator
    k = len(rank_devices)
    return RankPlan(world=k * n_proc, first=pid * k, devices=rank_devices,
                    backend=backend_for(rank_devices), address=address,
                    threads=max(1, torch.get_num_threads() // k))


def init_distributed(coordinator: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None,
                     data_parallel: int = 0, device="cuda",
                     devices=None) -> Optional[RankPlan]:
    """The rank plan of a trainer's flags; the coordinator flags fall back
    to ``GSEG_COORDINATOR``, ``GSEG_NUM_PROCESSES`` and
    ``GSEG_PROCESS_ID``.  Idempotent: inside a rank it returns that rank's
    plan whatever it is given.  Without a coordinator or a data axis it
    returns None and touches no CUDA."""
    if _joined is not None:
        return _joined.plan
    coordinator = coordinator or os.environ.get("GSEG_COORDINATOR")
    if num_processes is None and os.environ.get("GSEG_NUM_PROCESSES"):
        num_processes = int(os.environ["GSEG_NUM_PROCESSES"])
    if process_id is None and os.environ.get("GSEG_PROCESS_ID"):
        process_id = int(os.environ["GSEG_PROCESS_ID"])
    if coordinator is None and num_processes is not None \
            and num_processes > 1:
        raise ValueError("--num_processes needs --coordinator host:port")
    return plan_ranks(data_parallel, coordinator, num_processes, process_id,
                      device, devices)


# ---------------- inside a rank ----------------
def joined() -> bool:
    """True inside a rank of a data axis."""
    return _joined is not None


def rank() -> int:
    return _joined.rank if _joined is not None else 0


def world() -> int:
    return _joined.plan.world if _joined is not None else 1


def rank_device() -> Optional[torch.device]:
    """The rank's device, or None outside a rank."""
    return _joined.device if _joined is not None else None


def is_primary() -> bool:
    """True on the rank that writes the artifacts (rank 0), and outside a
    data axis."""
    return rank() == 0


def barrier(name: str, timeout_s: int = 3600) -> None:
    """Block until every rank reaches this point (no-op outside a data
    axis).  A rendezvous on the ranks' TCP store, not a device collective:
    ranks may be minutes apart (rank 0 scanning the dataset while the
    others wait for its statistics cache), longer than a collective's
    timeout should be."""
    if _joined is None:
        return
    use = _barrier_uses.get(name, 0)
    _barrier_uses[name] = use + 1
    key = f"gseg_barrier/{name}/{use}"
    store = _joined.store
    if store.add(key, 1) == _joined.plan.world:
        store.set(key + "/done", "1")
    store.wait([key + "/done"], datetime.timedelta(seconds=timeout_s))


def from_primary(name: str, value: str) -> str:
    """Rank 0's ``value`` on every rank, through the store (``value``
    itself outside a data axis): a decision only rank 0 may take, such as
    whether a file it is about to write exists."""
    if _joined is None:
        return value
    key = f"gseg_value/{name}"
    if _joined.rank == 0:
        _joined.store.set(key, value)
        return value
    return _joined.store.get(key).decode()


def report(**values) -> None:
    """Record values for the launcher (a rank's losses, its kernel
    launches); the launching call collects them in :data:`last_reports`.
    Outside a rank, nothing."""
    if _joined is not None:
        _report.update(values)


def shard_rows(batch, rank_: Optional[int] = None,
               world_: Optional[int] = None):
    """This rank's rows of a batch every rank holds: contiguous blocks in
    rank order, the ``P("data")`` layout.  The batch must split evenly."""
    rank_ = rank() if rank_ is None else rank_
    world_ = world() if world_ is None else world_
    n = batch.shape[0]
    if n % world_:
        raise ValueError(f"a batch of {n} rows does not split over a data "
                         f"axis of {world_}")
    k = n // world_
    return batch[rank_ * k:(rank_ + 1) * k]


def pad_rows(n: int) -> int:
    """Rows to add to a batch of ``n`` so that it splits over the world."""
    return (-n) % world()


def all_reduce_sum(t: torch.Tensor) -> torch.Tensor:
    """``t`` summed over the ranks (a new tensor; no gradient)."""
    out = t.detach().clone()
    if _joined is not None:
        dist.all_reduce(out)
    return out


class AllReduceSum(torch.autograd.Function):
    """Sum over the ranks; its gradient is the sum of the ranks' incoming
    gradients, as GSPMD's psum: each rank's share of the loss depends on
    every rank's summand."""

    @staticmethod
    def forward(ctx, x):
        out = x.clone()
        dist.all_reduce(out)
        return out

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone()
        dist.all_reduce(grad)
        return grad


def global_ratio(num: torch.Tensor, den: torch.Tensor,
                 floor: Optional[float] = None):
    """``num / den`` over the global batch, for a loss whose numerator and
    denominator are sums over rows: (this rank's share to backpropagate,
    its local numerator over the global denominator; the global value,
    detached).  The shares sum to the global value.  Outside a data axis
    both are ``num / den`` (``den`` at least ``floor``)."""
    if _joined is None:
        out = num / (den.clamp(min=floor) if floor is not None else den)
        return out, out.detach()
    sums = all_reduce_sum(torch.stack([num.detach().double(),
                                       den.detach().double()]))
    total = sums[1].clamp(min=floor) if floor is not None else sums[1]
    return num / total.to(num.dtype), (sums[0] / total).to(num.dtype)


def reduce_gradients(model: torch.nn.Module) -> None:
    """Sum every parameter's gradient over the ranks, after ``backward()``:
    one flattened ``all_reduce`` per dtype.  No-op outside a data axis."""
    if _joined is None:
        return
    by_dtype: Dict[torch.dtype, list] = {}
    for p in model.parameters():
        if p.grad is not None:
            by_dtype.setdefault(p.grad.dtype, []).append(p.grad)
    for grads in by_dtype.values():
        flat = torch.cat([g.reshape(-1) for g in grads])
        dist.all_reduce(flat)
        offset = 0
        for g in grads:
            g.copy_(flat[offset:offset + g.numel()].view_as(g))
            offset += g.numel()


def gather_rows(t: torch.Tensor) -> torch.Tensor:
    """Every rank's rows of ``t`` (equal shapes), in rank order, on every
    rank: the ranks' blocks placed into zeros and summed, which needs only
    ``all_reduce`` (gloo's on CUDA tensors too)."""
    if _joined is None:
        return t
    k = t.shape[0]
    out = torch.zeros((k * world(),) + tuple(t.shape[1:]), dtype=t.dtype,
                      device=t.device)
    out[rank() * k:(rank() + 1) * k] = t
    dist.all_reduce(out)
    return out


# ---------------- launching ----------------
def _join(plan: RankPlan, local: int) -> None:
    global _joined
    device = plan.devices[local]
    if device.type == "cuda":
        torch.cuda.set_device(device)
    global_rank = plan.first + local
    host, port = plan.address.rsplit(":", 1)
    store = dist.TCPStore(host, int(port), plan.world,
                          is_master=global_rank == 0,
                          timeout=datetime.timedelta(seconds=3600))
    dist.init_process_group(
        plan.backend, store=store, rank=global_rank, world_size=plan.world,
        timeout=datetime.timedelta(seconds=1800),
        **({"device_id": device} if plan.backend == "nccl" else {}))
    _joined = _Joined(plan, global_rank, device, store)
    if global_rank == 0:
        print(f"data axis: {plan.world} ranks, backend {plan.backend}",
              flush=True)


def _rank_main(local: int, plan: RankPlan, fn: Callable, args: tuple,
               kwargs: dict, results) -> None:
    torch.set_num_threads(plan.threads)
    _join(plan, local)
    try:
        value = fn(*args, **kwargs)
        results.put((local, value, dict(_report)))
    finally:
        dist.destroy_process_group()


def launch(plan: RankPlan, fn: Callable, *args, **kwargs):
    """Run ``fn(*args, **kwargs)`` on every local rank of ``plan``, each in
    a spawned process joined to the data axis; return what the first
    local rank returned (rank 0's, in a one-process launch).  A rank that
    raises stops the others and the exception is raised here.  ``fn`` and
    its arguments must pickle."""
    global last_reports
    import torch.multiprocessing as mp

    results = mp.get_context("spawn").SimpleQueue()
    ctx = mp.start_processes(_rank_main, args=(plan, fn, args, kwargs,
                                               results),
                             nprocs=plan.local, join=False,
                             start_method="spawn")
    got = {}

    def drain():
        while not results.empty():
            local, value, rep = results.get()
            got[local] = (value, rep)

    while not ctx.join(timeout=0.2):
        drain()
    drain()
    missing = [i for i in range(plan.local) if i not in got]
    if missing:
        raise RuntimeError(f"ranks {missing} returned nothing")
    last_reports = [got[i][1] for i in range(plan.local)]
    return got[0][0]


def run(plan: Optional[RankPlan], fn: Callable, *args, **kwargs):
    """``fn(*args, **kwargs)`` here when there is no plan or this process
    is already a rank, else on the plan's ranks through :func:`launch`."""
    if plan is None or _joined is not None:
        return fn(*args, **kwargs)
    return launch(plan, fn, *args, **kwargs)
