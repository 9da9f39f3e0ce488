"""Process groups for data-parallel training (counterpart of
`rlobjectdetection_tpu/parallel/distributed.py`).

One process a GPU. `initialize` joins this process into the group, over
NCCL on the card and gloo on the CPU, from explicit arguments (the CLIs'
`--dist_coordinator / --dist_nprocs / --dist_rank`) or from a launcher's
environment (torchrun, SLURM, mpirun, PMI). A launcher environment that
lacks what the group needs raises: N silent single-process jobs, each
training on the whole data, is the one outcome that must not happen.

A data-parallel step is the single-process step on the GLOBAL batch, exact
up to the reassociation of the gradient sum. Each rank holds rows
`host_local_batch_slice(B)` of the batch; `GlobalBatch` gives a rank's
step what it needs to compute the global step's numbers from its rows:
the global draws (each rank draws the global shape from the step's
generator and keeps its own rows), the first image's row (the anchor
layer's bounds), the global count behind a mean over a data-dependent
number of entries, and the metrics as global means and sums.
"""

from __future__ import annotations

import os
import socket
from dataclasses import dataclass
from datetime import timedelta

import numpy as np
import torch
import torch.distributed as dist

from .mesh import rank_device

# each launcher's variables: (rank, world size, local rank); the address
# comes from MASTER_ADDR / MASTER_PORT under every one of them
LAUNCHERS = {
    "torchrun": ("RANK", "WORLD_SIZE", "LOCAL_RANK"),
    "slurm": ("SLURM_PROCID", "SLURM_NTASKS", "SLURM_LOCALID"),
    "mpirun": ("OMPI_COMM_WORLD_RANK", "OMPI_COMM_WORLD_SIZE", "OMPI_COMM_WORLD_LOCAL_RANK"),
    "pmi": ("PMI_RANK", "PMI_SIZE", "MPI_LOCALRANKID"),
}
ADDRESS_ENV = ("MASTER_ADDR", "MASTER_PORT")


@dataclass(frozen=True)
class World:
    """This process's place in the group: rank, world size, local rank (its
    GPU on the host), the backend and the device it computes on."""
    rank: int
    size: int
    local_rank: int
    backend: str
    device: torch.device


def launcher_env(env=None) -> dict | None:
    """{rank, size, local_rank, coordinator} from the first launcher whose
    rank variable is set (torchrun's also where only WORLD_SIZE is), or
    None where none is, or where the launcher runs one task. Raises
    ValueError where one is set and any other the group needs is
    missing."""
    env = os.environ if env is None else env
    hinted = [name for name, keys in LAUNCHERS.items() if keys[0] in env]
    if not hinted and "WORLD_SIZE" not in env:
        return None
    name = hinted[0] if hinted else "torchrun"
    keys = LAUNCHERS[name]
    if env.get(keys[1]) == "1":
        return None           # a launcher's single task: no group to join
    missing = [k for k in keys + ADDRESS_ENV if k not in env]
    if missing:
        raise ValueError(
            f"a {name} launch environment is set but {', '.join(missing)} "
            f"{'is' if len(missing) == 1 else 'are'} missing: every process would train "
            f"alone on the whole data; set them, or unset the launcher's variables")
    return dict(rank=int(env[keys[0]]), size=int(env[keys[1]]), local_rank=int(env[keys[2]]),
                coordinator=f"{env['MASTER_ADDR']}:{env['MASTER_PORT']}")


def plan_group(coordinator: str | None = None, nprocs: int | None = None,
               rank: int | None = None, env=None) -> dict | None:
    """The group this process should join, {coordinator, size, rank,
    local_rank (None where the flags do not say)}: from the explicit
    arguments where any is given (all three are needed), else from a
    launcher's environment (`launcher_env`); None for a plain
    single-process run. Raises ValueError on what does not make a group."""
    if coordinator is None and nprocs is None and rank is None:
        return launcher_env(env)
    if coordinator is None or nprocs is None or rank is None:
        raise ValueError("a data-parallel run needs all of --dist_coordinator, --dist_nprocs "
                         "and --dist_rank")
    if nprocs < 1 or not 0 <= rank < nprocs:
        raise ValueError(f"rank {rank} is outside a world of {nprocs} processes")
    return dict(coordinator=coordinator, size=nprocs, rank=rank, local_rank=None)


def initialize(coordinator: str | None = None, nprocs: int | None = None,
               rank: int | None = None, *, device: str | torch.device = "cuda",
               backend: str | None = None, timeout_s: float = 1800.0,
               plan: dict | None = None) -> World | None:
    """Join the process group; returns this process's `World`, or None for a
    plain single-process run (`plan_group` finds no group).

    `coordinator` is host:port of rank 0's rendezvous (`tcp://`); `plan`,
    where given, replaces the three arguments. The backend is NCCL for a
    CUDA device and gloo for the CPU unless `backend` says otherwise (gloo
    over CUDA tensors lets several ranks share one GPU). A rank whose peers
    never arrive, or stop answering, raises after `timeout_s`. Raises
    ValueError on arguments that do not make a group."""
    plan = plan if plan is not None else plan_group(coordinator, nprocs, rank)
    if plan is None:
        return None
    dev = torch.device(device)
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    local_rank = plan["local_rank"]
    if local_rank is None:
        # explicit flags: ranks are numbered host by host, one GPU each
        count = torch.cuda.device_count() if dev.type == "cuda" else 1
        local_rank = int(os.environ.get("LOCAL_RANK", plan["rank"] % max(count, 1)))
    dev = rank_device(dev, backend, local_rank)
    dist.init_process_group(backend, init_method=f"tcp://{plan['coordinator']}",
                            world_size=plan["size"], rank=plan["rank"],
                            timeout=timedelta(seconds=timeout_s))
    return World(plan["rank"], plan["size"], local_rank, backend, dev)


def add_dist_args(parser) -> None:
    """The CLIs' data-parallel flags (torchrun's, SLURM's, mpirun's or PMI's
    environment does the same without them)."""
    parser.add_argument("--dist_coordinator", default=None,
                        help="host:port of rank 0's rendezvous, for a data-parallel run")
    parser.add_argument("--dist_nprocs", default=None, type=int,
                        help="processes of the data-parallel run, one a GPU")
    parser.add_argument("--dist_rank", default=None, type=int, help="this process's rank")
    parser.add_argument("--dist_backend", default=None, choices=["nccl", "gloo"],
                        help="default nccl on cuda, gloo on cpu; gloo lets ranks share a GPU")


def check_dist_args(parser, args, prog: str, batch_size: int | None = None) -> dict | None:
    """`plan_group` of the flags (or the launcher's environment); exits with
    code 2 and the reason where they make no group, or where `batch_size`
    does not divide by its size."""
    try:
        plan = plan_group(args.dist_coordinator, args.dist_nprocs, args.dist_rank)
    except ValueError as e:
        parser.exit(2, f"{prog}: {e}\n")
    if plan is not None and batch_size is not None and batch_size % plan["size"]:
        parser.exit(2, f"{prog}: --bs {batch_size} does not divide by the {plan['size']} "
                       f"processes of the data-parallel run: each takes an equal share of "
                       f"every batch\n")
    return plan


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def first_on_host() -> bool:
    """Whether this process is its host's lowest rank (the host's names
    gathered over the group; the local rank cannot say where ranks are
    placed by hand). True without a group. Every rank must call it."""
    if process_count() == 1:
        return True
    hosts = [None] * process_count()
    dist.all_gather_object(hosts, socket.gethostname())
    return hosts.index(hosts[process_index()]) == process_index()


def host_local_batch_slice(global_batch_size: int, size: int | None = None,
                           rank: int | None = None) -> tuple[int, int]:
    """(start, size) of a process's rows of the global batch, by default
    this process's in its group. Raises where the batch does not divide by
    the world: the remainder would be dropped in silence."""
    n = process_count() if size is None else size
    i = process_index() if rank is None else rank
    if global_batch_size % n:
        raise ValueError(f"global batch {global_batch_size} does not divide by {n} "
                         f"processes: the remainder would be dropped in silence")
    per = global_batch_size // n
    return i * per, per


def fetch_scalar(x) -> float:
    """float(x), averaged over the group where one is up (every rank must
    call it)."""
    t = torch.as_tensor(x, dtype=torch.float64).detach().clone()
    if process_count() > 1:
        if dist.get_backend() == "nccl":
            t = t.to(torch.device("cuda", torch.cuda.current_device()))
        dist.all_reduce(t)
        t = t / process_count()
    return float(t)


def shard_global_batch(batch: dict, device) -> dict:
    """This process's rows of a GLOBAL batch (every rank assembled the whole
    batch), on `device`."""
    def rows(v):
        start, size = host_local_batch_slice(v.shape[0])
        return torch.as_tensor(np.ascontiguousarray(v[start:start + size])).to(device)

    return {k: rows(v) for k, v in batch.items()}


def shard_local_batch(batch: dict, device) -> dict:
    """A batch of this process's rows only (`data/loader.py::HostShardLoader`
    assembled them on the global canvas) on `device`."""
    return {k: torch.as_tensor(np.ascontiguousarray(v)).to(device) for k, v in batch.items()}


class GlobalBatch:
    """What a rank's train step needs to compute the global batch's step
    from its own rows, over the default process group.

    Every method is a collective or a function of the group alone, called
    by every rank in the same order."""

    def __init__(self):
        self.rank, self.size = process_index(), process_count()

    def uniform(self, source):
        """A `models.targets.Uniform` that draws the GLOBAL shape from
        `source` and returns this rank's rows: a draw of `[n, ...]` local
        rows is the slice `[rank·n, (rank + 1)·n)` of the `[size·n, ...]`
        draw the single-process step makes (every draw of the step, the
        anchor and proposal layers' `[B, ...]` and the VGG head's dropout
        `[B·R, 4096]`, leads with the batch)."""
        def draw(shape):
            n = shape[0]
            full = source((n * self.size, *shape[1:]))
            return full[self.rank * n:(self.rank + 1) * n]

        return draw

    def first_row(self, x: torch.Tensor) -> torch.Tensor:
        """Rank 0's `x[:1]` on every rank: the global batch's first row."""
        row = x[:1].clone()
        if self.size > 1:
            dist.broadcast(row, 0)
        return row

    def count_share(self, local_count: torch.Tensor) -> torch.Tensor:
        """The denominator of this rank's share of a mean over the global
        batch's `local_count` entries: max(global count, 1) / size, so that
        the ranks' mean of their (local sum / share) is (global sum / global
        count), as the single-process mean."""
        total = local_count.detach().float().clone()
        if self.size > 1:
            dist.all_reduce(total)
        return total.clamp_min(1.0) / self.size

    def metrics(self, metrics: dict, sums=("fg_cnt", "bg_cnt")) -> dict:
        """Each metric over the global batch: the ranks' mean, or for the
        keys in `sums` their sum (one all-reduce)."""
        if self.size == 1:
            return metrics
        keys = list(metrics)
        vals = torch.stack([metrics[k].detach().float().reshape(()) for k in keys])
        dist.all_reduce(vals)
        return {k: vals[i] if k in sums else vals[i] / self.size for i, k in enumerate(keys)}

    def all_true(self, flag: bool) -> bool:
        """True where `flag` is True on every rank."""
        if self.size == 1:
            return flag
        dev = torch.device("cuda", torch.cuda.current_device()) if (
            dist.get_backend() == "nccl") else torch.device("cpu")
        t = torch.tensor([int(flag)], device=dev)
        dist.all_reduce(t, op=dist.ReduceOp.MIN)
        return bool(t.item())
