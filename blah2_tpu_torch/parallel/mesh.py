"""The (cpi, pulse) mesh of logical ranks (counterpart of
``blah2_tpu/parallel/mesh.py``).

JAX's ``shard_map`` is single-controller: one process drives every device of
the mesh. The port keeps that model. A mesh is a ``(n_cpi, n_pulse)`` grid of
logical ranks, rank ``r = c * n_pulse + p`` at cpi row ``c`` and pulse
column ``p``, each bound to a ``torch.device``; one Python process runs every
rank's work. Several ranks may share one device: ``devices=[cuda:0] * 4``
puts a 1 × 4 mesh on one card, and eight ranks on ``cpu`` stand in for the
JAX tests' eight virtual CPU devices. A mesh over several cards is the same
code with distinct devices.

Axes:

  - ``cpi``: independent CPIs on independent rank rows (data parallelism);
  - ``pulse``: one CPI's time axis split in contiguous pulse blocks over the
    ranks of a row (sequence parallelism).
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import torch

from blah2_tpu_torch.device import resolve_device

AXIS_NAMES = ("cpi", "pulse")


def _indexed(dev: torch.device) -> torch.device:
    """``cuda`` as ``cuda:<current>``, so that equal cards compare equal."""
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return dev


class RadarMesh:
    """A ``(n_cpi, n_pulse)`` grid of logical ranks and their devices."""

    def __init__(self, n_cpi: int, n_pulse: int,
                 devices: Sequence[torch.device]):
        devices = [_indexed(torch.device(d)) for d in devices]
        if n_cpi < 1 or n_pulse < 1 or n_cpi * n_pulse != len(devices):
            raise ValueError(f"mesh {n_cpi}x{n_pulse} != {len(devices)} "
                             f"devices")
        self.axis_names = AXIS_NAMES
        self.shape = {"cpi": int(n_cpi), "pulse": int(n_pulse)}
        self.devices: List[torch.device] = devices
        # The collectives append to this list while
        # ``collectives.count_bytes(mesh)`` is open.
        self.comm_log: Optional[list] = None

    @property
    def size(self) -> int:
        return len(self.devices)

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
        """The devices in use, in the order their first rank has them."""
        out: List[torch.device] = []
        for d in self.devices:
            if d not in out:
                out.append(d)
        return out

    def __repr__(self) -> str:
        return (f"RadarMesh({self.shape['cpi']}x{self.shape['pulse']}, "
                f"devices={[str(d) for d in self.devices]})")


def rank_devices(n_ranks: int, device=None) -> List[torch.device]:
    """Devices for ``n_ranks`` logical ranks: all on ``device`` when it is
    the CPU or names a card; otherwise (``None`` or ``"cuda"``) the visible
    cards filled in rank order, several ranks to a card when there are
    fewer cards than ranks (a 1 × 4 mesh on one card). Raises with no card
    unless the CPU is asked for."""
    dev = resolve_device(device)
    if dev.type != "cuda" or dev.index is not None:
        return [dev] * n_ranks
    per = -(-n_ranks // torch.cuda.device_count())
    return [torch.device("cuda", r // per) for r in range(n_ranks)]


def make_radar_mesh(
    n_cpi: Optional[int] = None,
    n_pulse: Optional[int] = None,
    devices: Optional[Sequence] = None,
) -> RadarMesh:
    """Build a (cpi, pulse) mesh over ``devices`` (default: every visible
    CUDA device, one rank each).

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
        devices = [torch.device("cuda", i) for i in range(n_cuda)]
    devices = list(devices)
    n = len(devices)
    if n_cpi is None and n_pulse is None:
        n_cpi, n_pulse = 1, n
    elif n_cpi is None:
        n_cpi = n // n_pulse
    elif n_pulse is None:
        n_pulse = n // n_cpi
    if n_cpi * n_pulse != n:
        raise ValueError(f"mesh {n_cpi}x{n_pulse} != {n} devices")
    return RadarMesh(n_cpi, n_pulse, devices)
