"""Process groups for data and tensor parallelism (counterpart of ``stutter_tpu/parallel/mesh.py``).

JAX drives every device of a host from one process; PyTorch runs one process
per card. A run on N cards is N processes ("ranks") in one
``torch.distributed`` group, and ``make_plan`` lays them out as a
[data, model] grid with the model axis fastest: rank = data index * model +
model index, so that a tensor-parallel group is consecutive ranks, which a
launcher numbering hosts in turn (``torchrun``, ``launch``) keeps on one host.

``MeshPlan`` holds this rank's place in the grid and three groups:
- the data group (the ranks that share its model index): gradients are
  summed over it;
- the model group (the ranks that share its data index): the Megatron
  all-reduces of ``parallel.collectives`` run over it;
- the host group (every rank, gloo): small gathers of pooled rows and
  metadata to rank 0, which writes the store, barriers, and the messages
  by which rank 0 leads the other ranks (``broadcast_round``: a server's
  rounds, the chunk count of a long clip, the augmented copies).
Device collectives take the default backend: NCCL on cards, gloo on the CPU.

``launch`` runs a function in N spawned worker processes, one per card, that
meet through a ``FileStore``; ``init_distributed`` joins a group set up by
``torchrun`` or spanning several hosts. One card needs neither: a run with
no plan (``None``) is the single-device run.
"""

from __future__ import annotations

import dataclasses
import datetime
import importlib
import os
import sys
from typing import Any, Callable

import numpy as np
import torch
import torch.distributed as dist

TIMEOUT = datetime.timedelta(seconds=1800)  # a collective or a store wait, then the run fails
# a leader with nothing to send sends an idle message this often (a share of
# TIMEOUT), so that ranks waiting in broadcast_round never reach the timeout
IDLE_SHARE = 0.1


@dataclasses.dataclass(frozen=True)
class MeshPlan:
    """This rank's place in the [data, model] grid and its groups."""

    rank: int
    world_size: int
    data_size: int
    model_size: int
    data_group: Any = None
    model_group: Any = None
    host_group: Any = None

    @property
    def data_rank(self) -> int:
        return self.rank // self.model_size

    @property
    def model_rank(self) -> int:
        return self.rank % self.model_size


def plan_shape(world: int, data: int | None = None, model: int = 1) -> tuple[int, int]:
    """(data, model) for ``world`` ranks; data defaults to world // model.
    Raises ``ValueError`` when data * model != world, as ``make_mesh`` does."""
    if data is None:
        data = world // model
    if model < 1 or data * model != world:
        raise ValueError(f"mesh {data}x{model} != {world} ranks")
    return data, model


def rank_grid(data: int, model: int) -> np.ndarray:
    """[data, model] global ranks, the model axis fastest."""
    return np.arange(data * model).reshape(data, model)


def make_plan(data: int | None = None, model: int = 1) -> MeshPlan:
    """The plan of this rank in the initialised default group. Every rank
    must call it, with the same arguments: it creates every group."""
    if not dist.is_initialized():
        raise RuntimeError("make_plan needs an initialised process group "
                           "(launch, init_distributed or torchrun)")
    world, rank = dist.get_world_size(), dist.get_rank()
    data, model = plan_shape(world, data, model)
    grid = rank_grid(data, model)
    data_group = model_group = None
    for j in range(model):  # every rank creates every group, in one order
        ranks = grid[:, j].tolist()
        group = dist.new_group(ranks)
        if rank in ranks:
            data_group = group
    for i in range(data):
        ranks = grid[i].tolist()
        group = dist.new_group(ranks)
        if rank in ranks:
            model_group = group
    host_group = (dist.group.WORLD if dist.get_backend() == "gloo"
                  else dist.new_group(backend="gloo", timeout=TIMEOUT))
    return MeshPlan(rank=rank, world_size=world, data_size=data, model_size=model,
                    data_group=data_group, model_group=model_group, host_group=host_group)


def shard_rows(plan: MeshPlan | None, n: int) -> slice:
    """This rank's contiguous rows of an n-row batch (n a multiple of the
    data size): data rank d takes rows [d n / D, (d + 1) n / D)."""
    if plan is None:
        return slice(0, n)
    if n % plan.data_size:
        raise ValueError(f"batch of {n} rows does not split over {plan.data_size} data ranks")
    per = n // plan.data_size
    return slice(plan.data_rank * per, (plan.data_rank + 1) * per)


def gather_rows(plan: MeshPlan | None, part: Any) -> list | None:
    """Gather one picklable part per data rank to rank 0 over the host group.
    Rank 0 gets the parts in data-rank order (model rank 0 of each data
    group: its model peers hold the same rows); every other rank gets None."""
    if plan is None:
        return [part]
    parts = [None] * plan.world_size if plan.rank == 0 else None
    dist.gather_object(part, parts, dst=0, group=plan.host_group)
    if plan.rank != 0:
        return None
    return [parts[d * plan.model_size] for d in range(plan.data_size)]


def broadcast_round(plan: MeshPlan, msg: Any = None) -> Any:
    """Rank 0's picklable ``msg`` on every rank, over the host group (the
    other ranks pass nothing). A rank waits here until rank 0 sends, at most
    the group's timeout: a leader that may wait longer for its own input
    sends an idle message every ``idle_interval_s()``."""
    box = [msg if plan.rank == 0 else None]
    dist.broadcast_object_list(box, src=0, group=plan.host_group)
    return box[0]


def idle_interval_s() -> float:
    """How long a leader may leave its followers waiting in
    ``broadcast_round``: a share of ``TIMEOUT``, read at the call, so that
    shortening ``TIMEOUT`` shortens both."""
    return TIMEOUT.total_seconds() * IDLE_SHARE


def barrier(plan: MeshPlan | None) -> None:
    if plan is not None:
        dist.barrier(group=plan.host_group)


def backend_for(device_type: str) -> str:
    return "nccl" if device_type == "cuda" else "gloo"


def _set_card(local_rank: int) -> torch.device:
    card = torch.device("cuda", local_rank % torch.cuda.device_count())
    torch.cuda.set_device(card)
    return card


def _build_kernels_once(local_rank: int) -> None:
    """On a card, local rank 0 builds the kernel library while the host's
    other ranks wait, so that N ranks do not run N builds at once."""
    from stutter_tpu_torch.ops import _build

    if local_rank == 0:
        _build.build()
    dist.barrier()


def init_distributed(coordinator_address: str | None = None,
                     num_processes: int | None = None, process_id: int | None = None,
                     local_rank: int | None = None, backend: str | None = None) -> None:
    """Join a process group spanning one or several hosts, one process per
    card (the counterpart of ``jax.distributed.initialize``).

    ``coordinator_address`` ("host:port" of rank 0), ``num_processes`` (the
    world size) and ``process_id`` (this rank) default to ``torchrun``'s
    ``MASTER_ADDR``/``MASTER_PORT``, ``WORLD_SIZE`` and ``RANK``;
    ``local_rank`` (this process's card) to ``LOCAL_RANK``. ``backend``
    defaults to NCCL where there is a card, else gloo. On a card, local rank
    0 then builds the kernels while the host's other ranks wait."""
    env = os.environ
    if coordinator_address is None:
        coordinator_address = f"{env['MASTER_ADDR']}:{env['MASTER_PORT']}"
    num_processes = int(env["WORLD_SIZE"]) if num_processes is None else num_processes
    process_id = int(env["RANK"]) if process_id is None else process_id
    local_rank = int(env.get("LOCAL_RANK", process_id)) if local_rank is None else local_rank
    backend = backend or backend_for("cuda" if torch.cuda.is_available() else "cpu")
    card = _set_card(local_rank) if backend == "nccl" else None
    dist.init_process_group(backend, init_method=f"tcp://{coordinator_address}",
                            world_size=num_processes, rank=process_id, timeout=TIMEOUT,
                            device_id=card)
    if torch.cuda.is_available() and backend == "nccl":
        _build_kernels_once(local_rank)


def _worker(local_rank: int, fn: Callable, args: tuple, world: int, device_type: str,
            backend: str, store_path: str) -> None:
    card = _set_card(local_rank) if device_type == "cuda" else None  # before any CUDA work
    dist.init_process_group(backend, store=dist.FileStore(store_path, world),
                            rank=local_rank, world_size=world, timeout=TIMEOUT,
                            device_id=card if backend == "nccl" else None)
    try:
        if device_type == "cuda":
            _build_kernels_once(local_rank)
        rc = fn(*args)
    finally:
        dist.destroy_process_group()
    if isinstance(rc, int) and rc:
        sys.exit(rc)


def launch(fn: Callable, nprocs: int, args: tuple = (), *, device_type: str = "cuda",
           backend: str | None = None, store_dir: str = ".") -> None:
    """Run ``fn(*args)`` in ``nprocs`` spawned processes joined in one group.

    Worker i takes card i (modulo the cards there are: two gloo ranks may
    share one card; NCCL refuses that) before any CUDA work, and the workers
    meet through a ``FileStore`` in ``store_dir``, removed afterwards.
    ``backend`` defaults to NCCL for cards and gloo for the CPU. ``fn`` must
    be importable (a module-level function). A worker that raises, or
    returns a nonzero int, fails the call with the worker's error."""
    backend = backend or backend_for(device_type)
    if device_type == "cuda" and backend == "nccl" and nprocs > torch.cuda.device_count():
        raise ValueError(f"{nprocs} NCCL ranks on {torch.cuda.device_count()} card(s): NCCL "
                         "puts one rank on a card; use backend='gloo' to share cards")
    os.makedirs(store_dir, exist_ok=True)
    store_path = os.path.join(os.path.abspath(store_dir),
                              f".torch_dist_store.{os.getpid()}.{id(fn):x}")
    try:
        torch.multiprocessing.start_processes(
            _worker, args=(fn, tuple(args), nprocs, device_type, backend, store_path),
            nprocs=nprocs, join=True, start_method="spawn")
    finally:
        if os.path.exists(store_path):
            os.remove(store_path)


def _cli_main(module: str, argv: list[str], logfile: str | None) -> int:
    from stutter_tpu_torch.utils.logging import inherit_logfile

    inherit_logfile(logfile)
    return importlib.import_module(module).main(argv)


def spawn_cli(module: str, argv: list[str], nprocs: int, device_type: str,
              store_dir: str, backend: str | None = None) -> int:
    """Run ``module.main(argv)`` on ``nprocs`` spawned ranks (``launch``;
    ``backend="gloo"`` lets several ranks share a card). Rank 0 logs into
    this process's logfile, if it has one (``utils/logging.py``)."""
    from stutter_tpu_torch.utils.logging import logfile

    launch(_cli_main, nprocs, (module, list(argv), logfile()), device_type=device_type,
           backend=backend, store_dir=store_dir)
    return 0
