"""Device meshes: an explicit list of torch devices on named axes, and
the multi-process bootstrap.

Counterpart of ``tpu_vector_db/parallel/mesh.py``. The JAX package drives
every device of a ``jax.sharding.Mesh`` from one process (``shard_map``
inside ``jax.jit``); the port does the same from one process over a list
of ``torch.device``s: each shard's tensors live on its device, each shard
is scanned there, and the k·P winners are copied to the lead device (the
mesh's first) for one merge.

* ``make_device_mesh`` lays a 1-D mesh over the store's rows
  (``SHARD_AXIS``). By default it takes the visible CUDA cards, and it
  raises where there is none. An explicit ``devices`` list may repeat a
  device (``["cuda:0"] * 4``, ``["cpu"] * 8``): shards that share a
  device behave as the JAX package's forced host devices do.
* ``make_serving_mesh`` is the 2-D (replica, shard) mesh: rows shard
  within a replica group, and each group serves its slice of the query
  batch.
* ``shard_range`` / ``local_count`` give shard ``s`` its rows,
  ``[s·cap/P, (s+1)·cap/P)``, the port's form of ``row_sharding``;
  ``shard_rows`` places a tensor's rows on a mesh that way.

Several processes (hosts) form one mesh through ``torch.distributed``:
``bootstrap_distributed`` starts a gloo process group (the JAX package
calls ``jax.distributed.initialize``), and ``make_device_mesh`` under
that group spans the processes. Each process lists only its own devices,
L of them, the same L on every process; process r of W holds global
shards ``[r·L, (r+1)·L)`` of P = L·W. Gloo carries the collectives on
host copies: the payload is a query's (Q, k) winners, and gloo fails a
collective at once when a peer's connection closes.
"""

from __future__ import annotations

import datetime
import logging
from dataclasses import dataclass

import torch

logger = logging.getLogger(__name__)

SHARD_AXIS = "shard"
REPLICA_AXIS = "replica"


@dataclass(frozen=True)
class Mesh:
    """``devices`` in row-major order over ``shape``, one axis name a
    dimension of the shape. A mesh that spans processes lists this
    process's devices only: it is process ``process_index`` of
    ``process_count``, whose shards are global shards
    ``[first_shard, first_shard + size)``."""
    devices: tuple[torch.device, ...]
    shape: tuple[int, ...]
    axis_names: tuple[str, ...]
    process_index: int = 0
    process_count: int = 1

    @property
    def size(self) -> int:
        """This process's shards (devices)."""
        return len(self.devices)

    @property
    def n_shards(self) -> int:
        """The global shard count P: every process holds ``size``."""
        return self.size * self.process_count

    @property
    def first_shard(self) -> int:
        """The global number of this process's first shard."""
        return self.process_index * self.size

    @property
    def multiprocess(self) -> bool:
        return self.process_count > 1

    @property
    def layout(self) -> tuple[int, int, int]:
        """(processes, this process's rank, its shards): what a file of
        one process's shards was written for."""
        return self.process_count, self.process_index, self.size

    @property
    def lead(self) -> torch.device:
        """The device the shards' winners are merged on."""
        return self.devices[0]

    def groups(self) -> list[list[torch.device]]:
        """The devices of each replica group (one group on a 1-D mesh),
        in shard order."""
        n = self.shape[-1]
        return [list(self.devices[i:i + n])
                for i in range(0, len(self.devices), n)]


def _resolve(device) -> torch.device:
    """A cuda or cpu device with its index; a CUDA device must exist."""
    dev = torch.device(device)
    if dev.type == "cpu":
        return torch.device("cpu")
    if dev.type != "cuda":
        raise ValueError(f"mesh devices are cuda or cpu, got {device!r}")
    if not torch.cuda.is_available():
        raise RuntimeError(f"CUDA is not available for mesh device "
                           f"{device!r}; pass devices=['cpu', ...]")
    index = torch.cuda.current_device() if dev.index is None else dev.index
    if index >= torch.cuda.device_count():
        raise ValueError(f"no CUDA device {index}: "
                         f"{torch.cuda.device_count()} visible")
    return torch.device("cuda", index)


def _devices(devices) -> list[torch.device]:
    """``devices`` resolved, or the visible CUDA cards."""
    if devices is not None:
        return [_resolve(d) for d in devices]
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device for the mesh; pass "
                           "devices=['cpu', ...] to shard on the CPU")
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def make_device_mesh(n_devices: int | None = None, devices=None) -> Mesh:
    """1-D mesh over the store's row dimension: the visible CUDA cards, or
    ``devices``, cut to the first ``n_devices``. Every device sees every
    query and scans its own rows. Under a process group the mesh spans
    the processes, these devices being this process's; every process
    must bring as many (one all-gather checks it)."""
    devs = _devices(devices)
    if n_devices is not None:
        if n_devices > len(devs):
            raise ValueError(
                f"requested {n_devices} devices, have {len(devs)}")
        devs = devs[:n_devices]
    if not devs:
        raise ValueError("a mesh needs at least one device")
    rank, world = process_index(), process_count()
    if world > 1:
        import torch.distributed as dist
        sizes = [torch.zeros(1, dtype=torch.int64) for _ in range(world)]
        dist.all_gather(sizes, torch.tensor([len(devs)]))
        sizes = [int(t) for t in sizes]
        if len(set(sizes)) != 1:
            raise ValueError(f"every process must hold as many shards; "
                             f"the processes hold {sizes}")
    return Mesh(tuple(devs), (len(devs) * world,), (SHARD_AXIS,),
                rank, world)


def make_serving_mesh(replicas: int, shards: int, devices=None) -> Mesh:
    """2-D serving mesh: rows shard across ``shard`` within a group
    (capacity), the store replicates across ``replica`` groups, each
    serving its own slice of the query batch (throughput)."""
    devs = _devices(devices)
    if replicas < 1 or shards < 1:
        raise ValueError(f"mesh {replicas}x{shards} is empty")
    if replicas * shards > len(devs):
        raise ValueError(
            f"mesh {replicas}x{shards} exceeds {len(devs)} devices")
    return Mesh(tuple(devs[: replicas * shards]), (replicas, shards),
                (REPLICA_AXIS, SHARD_AXIS))


def shard_range(capacity: int, n_shards: int, shard: int) -> tuple[int, int]:
    """Rows ``[lo, hi)`` of ``shard`` when ``capacity`` rows split evenly
    over ``n_shards``."""
    if capacity % n_shards:
        raise ValueError(f"capacity {capacity} does not split over "
                         f"{n_shards} shards")
    rows = capacity // n_shards
    return shard * rows, (shard + 1) * rows


def local_count(count: int, rows_per_shard: int, shard: int) -> int:
    """Live rows of ``shard``: the global count clipped to its range."""
    return max(0, min(int(count) - shard * rows_per_shard, rows_per_shard))


def shard_rows(mesh: Mesh, x: torch.Tensor) -> list:
    """``x``'s rows split over the shard axis, each part on its device:
    a list of P tensors on a 1-D mesh, one such list a replica group on
    a 2-D mesh (every group holds all the rows)."""
    out = [[x[slice(*shard_range(x.shape[0], len(group), s))].to(dev)
            for s, dev in enumerate(group)] for group in mesh.groups()]
    return out[0] if len(mesh.shape) == 1 else out


# ------------------------------------------------------------ processes

def _group_up() -> bool:
    import torch.distributed as dist
    return dist.is_available() and dist.is_initialized()


def process_index() -> int:
    """This process's rank in the process group; 0 without one."""
    import torch.distributed as dist
    return dist.get_rank() if _group_up() else 0


def process_count() -> int:
    """The processes in the process group; 1 without one."""
    import torch.distributed as dist
    return dist.get_world_size() if _group_up() else 1


def bootstrap_distributed(coordinator_address: str | None = None,
                          num_processes: int | None = None,
                          process_id: int | None = None,
                          timeout_s: float | None = None) -> bool:
    """Join the gloo process group at ``tcp://coordinator_address``
    (host:port; process 0 listens there). A no-op, returning False, when
    the group is up already or there is one process; True when it joined.

    Unlike the JAX function, which logs and carries on single-host, a
    group that cannot form raises (within ``timeout_s``, which also
    bounds every collective of the group): a host that served alone would
    answer from its own shards only."""
    import torch.distributed as dist
    if _group_up() or not num_processes or num_processes == 1:
        return False
    if not coordinator_address or process_id is None:
        raise ValueError(f"a process group of {num_processes} needs a "
                         "coordinator address and a process id")
    kw = {}
    if timeout_s is not None:
        kw["timeout"] = datetime.timedelta(seconds=timeout_s)
    dist.init_process_group(
        "gloo", init_method=f"tcp://{coordinator_address}",
        world_size=int(num_processes), rank=int(process_id), **kw)
    logger.info("torch.distributed (gloo) up: process %d/%d",
                process_index(), process_count())
    return True
