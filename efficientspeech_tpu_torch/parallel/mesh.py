"""Process meshes for data, tensor and sequence parallelism (counterpart of
the JAX package's ``parallel/mesh.py``).

JAX runs one program over a ``jax.sharding.Mesh`` of devices and XLA
inserts the collectives.  Here each device is a process (a rank) of a
``torch.distributed`` group, and a ``Mesh`` names this rank's place in a
row-major grid of ranks: its coordinate on each axis and, for each axis
longer than one, the process group of the ranks that differ from it on
that axis alone.  ``make_mesh`` builds the ("data", "model") grid of the
JAX package; a ``Mesh`` of other axes (("sp",), ("data", "sp")) serves
the sequence-parallel vocoder.

``launch`` spawns the ranks: ``torch.multiprocessing`` with the spawn
start method (a CUDA context does not survive fork) and a ``file://``
rendezvous in a fresh temporary directory, so no port is fixed and
launches side by side do not meet.  The backend follows the devices:
NCCL when every rank has a card of its own, gloo for CPU ranks, and
gloo on ranks that share a card only when the caller asks for it.
"""

import dataclasses
import datetime
import itertools
import math
import os
import signal
import tempfile
import threading
from typing import Callable, Dict, List, Optional, Sequence, Union

import numpy as np
import torch
import torch.distributed as dist

DeviceLike = Union[str, torch.device]

# how long a rank waits in a collective before it gives up
COLLECTIVE_TIMEOUT_S = 600


@dataclasses.dataclass
class Mesh:
    """This rank's place in a grid of ranks.  ``shape`` is the ordered
    {axis: size}; ranks are numbered row-major over it.  ``groups`` holds
    the process group of each axis longer than one (None where the axis
    has one rank); ``host_group`` is a gloo group over every rank for
    host-side agreement (the stop flag, barriers).  A mesh of more than
    one rank made outside a process group is a plan: it can be checked
    and sized but not run (``connected`` False)."""

    shape: Dict[str, int]
    rank: int = 0
    groups: Dict[str, Optional[dist.ProcessGroup]] = dataclasses.field(
        default_factory=dict)
    host_group: Optional[dist.ProcessGroup] = None
    connected: bool = True

    @property
    def size(self) -> int:
        return math.prod(self.shape.values())

    def coords(self, rank: Optional[int] = None) -> Dict[str, int]:
        rank = self.rank if rank is None else rank
        sizes = list(self.shape.values())
        return {a: int(i) for a, i in zip(
            self.shape, np.unravel_index(rank, sizes))}

    def index(self, axis: str) -> int:
        """This rank's coordinate on ``axis`` (0 on an axis the mesh
        lacks)."""
        return self.coords()[axis] if axis in self.shape else 0

    def axis_size(self, axis: str) -> int:
        return self.shape.get(axis, 1)

    def group(self, axis: str) -> Optional[dist.ProcessGroup]:
        """The process group along ``axis``; None when it has one rank."""
        if not self.connected:
            raise RuntimeError(
                f"mesh {self.shape} was made outside a process group: run "
                "its ranks through parallel.launch")
        return self.groups.get(axis)

    @classmethod
    def create(cls, shape: Dict[str, int]) -> "Mesh":
        """The mesh of ``shape`` for this process: inside a process group
        its rank and axis groups (every rank must call this, in the same
        order, as ``dist.new_group`` requires); outside one rank 0, and a
        plan when the mesh has more than one rank."""
        shape = {k: int(v) for k, v in shape.items()}
        total = math.prod(shape.values())
        if not dist.is_initialized():
            return cls(shape, connected=total == 1)
        world = dist.get_world_size()
        if total != world:
            raise ValueError(f"mesh {shape} has {total} ranks, the process "
                             f"group {world}")
        mesh = cls(shape, rank=dist.get_rank())
        for axis, size in shape.items():
            if size == 1:
                continue
            others = [a for a in shape if a != axis]
            for fixed in itertools.product(*(range(shape[a])
                                              for a in others)):
                ranks = [r for r in range(world)
                         if [mesh.coords(r)[a] for a in others]
                         == list(fixed)]
                group = dist.new_group(ranks)
                if mesh.rank in ranks:
                    mesh.groups[axis] = group
        if world > 1:
            mesh.host_group = dist.new_group(backend="gloo")
        return mesh


def make_mesh(data_parallel: Optional[int] = None, model_parallel: int = 1,
              devices: Optional[Sequence[DeviceLike]] = None) -> Mesh:
    """The ("data", "model") mesh of the JAX package's ``make_mesh``.
    ``devices`` default: the ranks of the process group this runs in, or
    outside one every CUDA card.  ``data_parallel`` default: all of them
    over ``model_parallel``.  A mesh larger than the devices raises the
    JAX package's message."""
    if devices is not None:
        n = len(devices)
    elif dist.is_initialized():
        n = dist.get_world_size()
    else:
        n = torch.cuda.device_count()
    if data_parallel is None:
        data_parallel = n // model_parallel
    if data_parallel * model_parallel > n or data_parallel < 1:
        raise ValueError(f"mesh {data_parallel}x{model_parallel} exceeds "
                         f"{n} devices")
    return Mesh.create({"data": data_parallel, "model": model_parallel})


def shard_rows(n: int, mesh: Optional[Mesh], axis: str = "data") -> slice:
    """The contiguous rows of a length-``n`` leading axis that this rank
    holds under ``P(axis)``: rank i of k holds [i·n/k, (i+1)·n/k)."""
    k = 1 if mesh is None else mesh.axis_size(axis)
    if n % k:
        raise ValueError(f"{n} rows do not split over {k} {axis!r} ranks")
    i = 0 if mesh is None else mesh.index(axis)
    return slice(i * n // k, (i + 1) * n // k)


def shard_batch(batch: Dict, mesh: Optional[Mesh], axis: str = "data"
                ) -> Dict:
    """This rank's rows of every array (or list) of ``batch``: the
    ``P("data")`` split of the JAX package's ``shard_batch``."""
    n = {len(v) for v in batch.values()}
    if len(n) != 1:
        raise ValueError(f"batch entries differ in length: {sorted(n)}")
    rows = shard_rows(n.pop(), mesh, axis)
    return {k: v[rows] for k, v in batch.items()}


def barrier(mesh: Optional[Mesh]):
    """Wait for every rank of the mesh (a one-element all-reduce on the
    host group: gloo's barrier is CPU-only, and this works under any
    backend)."""
    if mesh is not None and mesh.host_group is not None:
        dist.all_reduce(torch.zeros(1), group=mesh.host_group)


def any_rank(flag: bool, mesh: Optional[Mesh]) -> bool:
    """True on every rank when ``flag`` is true on any (a max over the
    host group; no device work)."""
    if mesh is None or mesh.host_group is None:
        return flag
    t = torch.tensor([1.0 if flag else 0.0])
    dist.all_reduce(t, op=dist.ReduceOp.MAX, group=mesh.host_group)
    return bool(t.item() > 0)


def _normal_device(device: DeviceLike) -> torch.device:
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", 0)
    return device


def pick_backend(devices: Sequence[DeviceLike],
                 backend: Optional[str] = None) -> str:
    """NCCL when every rank has a card of its own, gloo for CPU ranks.
    Ranks that share a card (NCCL refuses two ranks on one device) or mix
    kinds need ``backend="gloo"`` asked for: nothing switches silently."""
    devices = [_normal_device(d) for d in devices]
    kinds = {d.type for d in devices}
    distinct = len(set(devices)) == len(devices)
    if backend is None:
        if kinds == {"cuda"} and distinct:
            return "nccl"
        if kinds == {"cpu"}:
            return "gloo"
        raise ValueError(f"ranks on {[str(d) for d in devices]}: NCCL needs "
                         "a card per rank; pass backend='gloo' to run them "
                         "over gloo")
    if backend == "nccl" and not (kinds == {"cuda"} and distinct):
        raise ValueError(f"NCCL needs a card per rank, not "
                         f"{[str(d) for d in devices]}")
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"unknown backend {backend!r}")
    return backend


def _rank_main(rank: int, world: int, devices: List[torch.device],
               backend: str, root: str):
    # the call is read from a file, not the spawn pipe: a rank that dies
    # before reading a large argument from the pipe would block the
    # parent's write of it
    fn, args = torch.load(os.path.join(root, "call.pt"), weights_only=False)
    device = devices[rank]
    if device.type == "cuda":
        torch.cuda.set_device(device)
    else:
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    dist.init_process_group(
        backend, init_method=f"file://{os.path.join(root, 'rendezvous')}",
        world_size=world, rank=rank,
        timeout=datetime.timedelta(seconds=COLLECTIVE_TIMEOUT_S))
    try:
        out = fn(device, *args)
        torch.save(out, os.path.join(root, f"rank{rank}.pt"))
        # no rank leaves while another may still need it in a collective
        dist.all_reduce(torch.zeros(1, device=device if backend == "nccl"
                                    else "cpu"))
    finally:
        dist.destroy_process_group()


def launch(fn: Callable, world: int,
           devices: Optional[Sequence[DeviceLike]] = None,
           backend: Optional[str] = None, args: tuple = ()) -> list:
    """Run ``fn(device, *args)`` in ``world`` spawned ranks of one process
    group and return their results by rank (written with ``torch.save``
    and read back here).  ``fn`` must be importable by name (spawned
    ranks import it afresh).  ``devices``: one per rank, default the
    first ``world`` cards; the backend follows ``pick_backend``.  A rank
    that raises ends the launch with that error (the others are stopped).
    SIGTERM and SIGINT sent to this process are passed on to the ranks,
    whose training loops stop together after the same step."""
    if devices is None:
        if torch.cuda.device_count() < world:
            raise ValueError(f"mesh {world}x1 exceeds "
                             f"{torch.cuda.device_count()} devices")
        devices = [torch.device("cuda", i) for i in range(world)]
    devices = [_normal_device(d) for d in devices]
    if len(devices) != world:
        raise ValueError(f"{len(devices)} devices for {world} ranks")
    backend = pick_backend(devices, backend)
    with tempfile.TemporaryDirectory(prefix="es_launch_") as root:
        torch.save((fn, args), os.path.join(root, "call.pt"))
        ctx = torch.multiprocessing.start_processes(
            _rank_main, args=(world, devices, backend, root),
            nprocs=world, join=False, start_method="spawn")
        forwarded = {}
        if threading.current_thread() is threading.main_thread():
            def forward(signum, _frame):
                for p in ctx.processes:
                    if p.is_alive():
                        os.kill(p.pid, signum)

            for sig in (signal.SIGTERM, signal.SIGINT):
                forwarded[sig] = signal.signal(sig, forward)
        try:
            while not ctx.join():
                pass
        finally:
            for sig, handler in forwarded.items():
                signal.signal(sig, handler)
        return [torch.load(os.path.join(root, f"rank{r}.pt"),
                           weights_only=False) for r in range(world)]
