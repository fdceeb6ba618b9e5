"""The multi-host topology layer (the port of the host-side half of
``repro.launch.mesh``).

Multi-host wiring (used by ``launch/supervisor.py`` + ``launch/train.py``):

- :class:`HostTopology` maps global device ids to host ranks (contiguous
  slices, one host's cards after another's), gives each host its ring
  neighbours, and -- given a partition's stage->device map -- names the
  pipeline ring hops that cross host boundaries (the links a dead host
  severs, which is why one stalled collective silences the whole ring).
- :class:`FileBarrier` is a shared-filesystem rendezvous for worker
  processes (each participant atomically drops a marker file and waits
  for the full set): workers use it to enter the step loop together, and
  the checkpoint layer's ``wait_step_complete`` plays the same role on
  step commit with the shard files themselves as the markers.

Both are the JAX classes unchanged: pure Python, no torch, so the
supervisor can import them on a node whose accelerator runtime is wedged.
The marker names are the JAX package's, so a worker of either package
meets a worker of the other at one barrier.

The rank grid is the counterpart of ``make_production_mesh``,
``mesh_axis_sizes`` and ``dp_size``, which build and read a JAX device
``Mesh``: :func:`make_rank_grid` lays the world's processes out as a
``(data, model)`` grid of process groups (rank = data index x pp + pipeline
index, the JAX mesh's row-major device order), one process per pipeline
device: a rank's pipeline ring runs over its ``model_group`` and the
collectives of data parallelism and ZeRO over its ``data_group``.
``torch.distributed`` is imported inside the function, so the rest of the
module stays importable without it.
"""
from __future__ import annotations

import dataclasses
import os
import time


# ---------------------------------------------------------------------------
# The rank grid: (data, model) process groups, one process per device
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class RankGrid:
    """This process's place in a ``(data, model)`` grid of ``world =
    dp x pp`` processes: ``model_group`` is its pipeline (the ranks of its
    data row, in pipeline order), ``data_group`` its data-parallel peers
    (the ranks of its pipeline column)."""

    world: int
    dp: int
    pp: int
    rank: int
    model_group: object = None
    data_group: object = None

    @property
    def pipe_index(self) -> int:
        return self.rank % self.pp

    @property
    def data_index(self) -> int:
        return self.rank // self.pp

    def rank_of(self, pipe: int, data: int) -> int:
        """The rank of grid point (pipeline index ``pipe``, data index
        ``data``)."""
        return data * self.pp + pipe


def make_rank_grid(pp: int, *, dp: int = 1) -> RankGrid:
    """The grid of the initialized default process group's world, which
    must hold ``dp x pp`` processes.  Every rank calls it (it creates the
    groups, all of them in the same order on every rank)."""
    import torch.distributed as dist
    world, rank = dist.get_world_size(), dist.get_rank()
    if world != dp * pp:
        raise ValueError(f"a (data={dp}, model={pp}) grid needs "
                         f"{dp * pp} processes; the world has {world}")
    model_groups = [dist.new_group(list(range(i * pp, (i + 1) * pp)))
                    for i in range(dp)]
    data_groups = [dist.new_group(list(range(j, world, pp)))
                   for j in range(pp)]
    return RankGrid(world, dp, pp, rank, model_groups[rank // pp],
                    data_groups[rank % pp])


def mesh_axis_sizes(grid: RankGrid) -> dict:
    return {"data": grid.dp, "model": grid.pp}


def dp_size(grid: RankGrid, batch_axes=("pod", "data")) -> int:
    sizes = mesh_axis_sizes(grid)
    out = 1
    for a in batch_axes:
        out *= sizes.get(a, 1)
    return out


# ---------------------------------------------------------------------------
# Multi-host topology
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class HostTopology:
    """Host rank <-> device mapping for a multi-process launch.

    Devices are numbered globally and sliced contiguously per host (host
    ``h`` owns ``[h * devices_per_host, (h+1) * devices_per_host)``).
    """

    num_hosts: int
    devices_per_host: int

    def __post_init__(self):
        if self.num_hosts < 1 or self.devices_per_host < 1:
            raise ValueError(
                f"HostTopology needs num_hosts >= 1 and devices_per_host "
                f">= 1, got {self.num_hosts} x {self.devices_per_host}")

    @property
    def num_devices(self) -> int:
        return self.num_hosts * self.devices_per_host

    def host_of_device(self, device: int) -> int:
        if not 0 <= device < self.num_devices:
            raise ValueError(f"device {device} outside the "
                             f"{self.num_devices}-device topology")
        return device // self.devices_per_host

    def host_devices(self, host: int) -> range:
        if not 0 <= host < self.num_hosts:
            raise ValueError(f"host {host} outside the "
                             f"{self.num_hosts}-host topology")
        lo = host * self.devices_per_host
        return range(lo, lo + self.devices_per_host)

    def ring_neighbors(self, host: int) -> tuple[int, int]:
        """(previous, next) host on the host-level ring."""
        if not 0 <= host < self.num_hosts:
            raise ValueError(f"host {host} outside the "
                             f"{self.num_hosts}-host topology")
        return ((host - 1) % self.num_hosts, (host + 1) % self.num_hosts)

    def cross_host_edges(self, stage_devices) -> list[tuple[int, int]]:
        """Host pairs exchanging pipeline boundary hops, from a
        partition's stage->device map (``Partition.devices``): the unique
        (host_a, host_b) pairs, first crossing first."""
        edges: list[tuple[int, int]] = []
        seen: set[tuple[int, int]] = set()
        devs = [int(d) for d in stage_devices]
        for a, b in zip(devs, devs[1:]):
            ha, hb = self.host_of_device(a), self.host_of_device(b)
            if ha != hb and (ha, hb) not in seen:
                seen.add((ha, hb))
                edges.append((ha, hb))
        return edges

    def describe(self, stage_devices=None) -> str:
        lines = [f"hosts: {self.num_hosts} x {self.devices_per_host} "
                 f"devices = {self.num_devices}"]
        for h in range(self.num_hosts):
            prev, nxt = self.ring_neighbors(h)
            lines.append(f"  host {h}: devices "
                         f"{list(self.host_devices(h))}, ring prev={prev} "
                         f"next={nxt}")
        if stage_devices is not None:
            lines.append(f"  cross-host hops: "
                         f"{self.cross_host_edges(stage_devices) or 'none'}")
        return "\n".join(lines)


# ---------------------------------------------------------------------------
# File-based rendezvous
# ---------------------------------------------------------------------------

class BarrierTimeout(TimeoutError):
    """A :class:`FileBarrier` participant gave up waiting -- some host
    never arrived (dead, hung, or still starting past the timeout)."""

    def __init__(self, name: str, missing: list[int], timeout: float):
        self.name = name
        self.missing = missing
        super().__init__(
            f"barrier {name!r}: host(s) {missing} did not arrive within "
            f"{timeout:.1f}s")


class FileBarrier:
    """Shared-filesystem rendezvous for worker processes.

    ``wait(name)`` atomically drops ``<dir>/<name>.h<rank>`` and blocks
    until all ``num_hosts`` marker files exist.  Names must be unique per
    rendezvous (callers append the step/generation); markers persist so
    late arrivals sail through -- reuse a name only after ``reset``.
    """

    def __init__(self, directory: str, *, host_id: int, num_hosts: int):
        self.directory = directory
        self.host_id = host_id
        self.num_hosts = num_hosts
        os.makedirs(directory, exist_ok=True)

    def _marker(self, name: str, host: int) -> str:
        return os.path.join(self.directory, f"{name}.h{host:05d}")

    def wait(self, name: str, *, timeout: float = 120.0,
             poll: float = 0.05) -> None:
        tmp = self._marker(name, self.host_id) + f".tmp{os.getpid()}"
        with open(tmp, "w") as f:
            f.write(str(os.getpid()))
        os.replace(tmp, self._marker(name, self.host_id))
        deadline = time.time() + timeout
        while True:
            missing = [h for h in range(self.num_hosts)
                       if not os.path.exists(self._marker(name, h))]
            if not missing:
                return
            if time.time() > deadline:
                raise BarrierTimeout(name, missing, timeout)
            time.sleep(poll)

    def reset(self, name: str) -> None:
        for h in range(self.num_hosts):
            try:
                os.remove(self._marker(name, h))
            except OSError:
                pass
