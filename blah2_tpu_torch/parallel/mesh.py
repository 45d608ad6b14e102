"""The (cpi, pulse) mesh of logical ranks (counterpart of
``blah2_tpu/parallel/mesh.py``).

A mesh is a ``(n_cpi, n_pulse)`` grid of logical ranks, rank
``r = c * n_pulse + p`` at cpi row ``c`` and pulse column ``p``, each bound to
a ``torch.device``. One Python process runs the work of all of its ranks, as
JAX's ``shard_map`` runs every device of a process. Several ranks may share
one device: ``devices=[cuda:0] * 4`` puts a 1 × 4 mesh on one card, and eight
ranks on ``cpu`` stand in for the JAX tests' eight virtual CPU devices. A
mesh over several cards is the same code with distinct devices.

After ``parallel.distributed.maybe_initialize`` a mesh spans every process
of the job: process k owns the contiguous run of ranks
``k * size / n .. (k + 1) * size / n - 1`` (JAX's global device order), so a
2 × 4 mesh over two processes puts one cpi row in each and a 1 × 8 mesh
splits one CPI's time axis across the process boundary. ``devices`` then
names the devices of this process's ranks only; ``devices[r]`` is None where
rank r belongs to another process, and the per-rank lists of the sharded
pipeline hold tensors only at the local ranks.

Axes:

  - ``cpi``: independent CPIs on independent rank rows (data parallelism);
  - ``pulse``: one CPI's time axis split in contiguous pulse blocks over the
    ranks of a row (sequence parallelism).
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import torch

from blah2_tpu_torch.device import resolve_device
from blah2_tpu_torch.parallel import distributed

AXIS_NAMES = ("cpi", "pulse")


def _indexed(dev: torch.device) -> torch.device:
    """``cuda`` as ``cuda:<current>``, so that equal cards compare equal."""
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return dev


class RadarMesh:
    """A ``(n_cpi, n_pulse)`` grid of logical ranks and their devices.

    ``devices``: one device per rank of this process, in rank order (in one
    process, one per rank of the mesh)."""

    def __init__(self, n_cpi: int, n_pulse: int,
                 devices: Sequence[torch.device]):
        local = [_indexed(torch.device(d)) for d in devices]
        self.process_count = distributed.process_count()
        self.process_index = distributed.process_index()
        size = int(n_cpi) * int(n_pulse)
        if n_cpi < 1 or n_pulse < 1 or size != len(local) * \
                self.process_count:
            raise ValueError(f"mesh {n_cpi}x{n_pulse} != {len(local)} "
                             f"devices x {self.process_count} processes")
        self.axis_names = AXIS_NAMES
        self.shape = {"cpi": int(n_cpi), "pulse": int(n_pulse)}
        self.per_process = len(local)
        first = self.process_index * self.per_process
        self.local_ranks: List[int] = list(range(first,
                                                 first + self.per_process))
        self.devices: List[Optional[torch.device]] = [None] * size
        self.devices[first:first + self.per_process] = local
        # The host of each process (for the halo's routes across processes).
        job = distributed.job()
        self.hosts = job.hosts if job is not None else ("",)
        self._crosses = {axis: any(
            len({self.process_of(r) for r in g}) > 1
            for g in self.groups(axis)) for axis in AXIS_NAMES}
        # The collectives append to this list while
        # ``collectives.count_bytes(mesh)`` is open.
        self.comm_log: Optional[list] = None

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def device(self) -> torch.device:
        """The device of this process's first rank: where the sharded
        pipeline keeps its constants and returns its products."""
        return self.devices[self.local_ranks[0]]

    def process_of(self, rank: int) -> int:
        """The process that owns ``rank``."""
        return rank // self.per_process

    def is_local(self, rank: int) -> bool:
        return self.process_of(rank) == self.process_index

    def crosses(self, axis: str) -> bool:
        """Whether a group of ``axis`` spans more than one process."""
        return self._crosses[axis]

    def coords(self, rank: int):
        """``(cpi, pulse)`` coordinates of ``rank``."""
        return divmod(rank, self.shape["pulse"])

    def axis_index(self, rank: int, axis: str) -> int:
        """The rank's coordinate on ``axis`` (``lax.axis_index``)."""
        c, p = self.coords(rank)
        return {"cpi": c, "pulse": p}[axis]

    def groups(self, axis: str) -> List[List[int]]:
        """The ranks that ``axis`` joins, one list per group, in axis order:
        for ``pulse`` one list per cpi row, for ``cpi`` one per column."""
        n_c, n_p = self.shape["cpi"], self.shape["pulse"]
        if axis == "pulse":
            return [[c * n_p + p for p in range(n_p)] for c in range(n_c)]
        if axis == "cpi":
            return [[c * n_p + p for c in range(n_c)] for p in range(n_p)]
        raise ValueError(f"unknown mesh axis {axis!r}")

    def distinct_devices(self) -> List[torch.device]:
        """This process's devices, in the order their first rank has
        them."""
        out: List[torch.device] = []
        for d in self.devices:
            if d is not None and d not in out:
                out.append(d)
        return out

    def __repr__(self) -> str:
        return (f"RadarMesh({self.shape['cpi']}x{self.shape['pulse']}, "
                f"devices={[str(d) for d in self.devices]}, process "
                f"{self.process_index}/{self.process_count})")


def _cards() -> List[int]:
    """This process's cards: its share in a job, else every visible one."""
    job = distributed.job()
    if job is not None and job.cards:
        return list(job.cards)
    return list(range(torch.cuda.device_count()))


def rank_devices(n_ranks: int, device=None) -> List[torch.device]:
    """Devices for ``n_ranks`` logical ranks of this process: all on
    ``device`` when it is the CPU or names a card; otherwise (``None`` or
    ``"cuda"``) this process's cards (in a job, its share; else every
    visible card) filled in rank order, several ranks to a card when there
    are fewer cards than ranks (a 1 × 4 mesh on one card). Raises with no
    card unless the CPU is asked for."""
    dev = resolve_device(device)
    if dev.type != "cuda" or dev.index is not None:
        return [dev] * n_ranks
    cards = _cards()
    per = -(-n_ranks // len(cards))
    return [torch.device("cuda", cards[r // per]) for r in range(n_ranks)]


def make_radar_mesh(
    n_cpi: Optional[int] = None,
    n_pulse: Optional[int] = None,
    devices: Optional[Sequence] = None,
) -> RadarMesh:
    """Build a (cpi, pulse) mesh over ``devices``, this process's devices
    (default: its cards, one rank each; in a job, the mesh spans every
    process's).

    Defaults: all ranks on the pulse axis unless ``n_cpi`` is given. The CPU
    is used only when the caller passes CPU devices; with no card and no
    ``devices`` this raises.
    """
    if devices is None:
        n_cuda = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if n_cuda == 0:
            raise RuntimeError(
                "blah2_tpu_torch: no CUDA device is available; pass "
                "devices=['cpu'] * n to build a mesh on the CPU explicitly")
        devices = [torch.device("cuda", i) for i in _cards()]
    devices = list(devices)
    n = len(devices) * distributed.process_count()
    if n_cpi is None and n_pulse is None:
        n_cpi, n_pulse = 1, n
    elif n_cpi is None:
        n_cpi = n // n_pulse
    elif n_pulse is None:
        n_pulse = n // n_cpi
    if n_cpi * n_pulse != n:
        raise ValueError(f"mesh {n_cpi}x{n_pulse} != {n} devices")
    return RadarMesh(n_cpi, n_pulse, devices)
