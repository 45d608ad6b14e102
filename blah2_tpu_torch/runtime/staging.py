"""Host-to-card and card-to-host copies of the radar runtime.

Chunked ingest stages each wire chunk in a pinned host buffer and copies it
to the card with ``non_blocking=True`` on a copy stream of its own, so the
host goes on to the next chunk while the copy is in flight (a non-blocking
copy from pageable memory would wait for itself). The pinned buffers form a
small ring per chunk shape, each guarded by the event of the copy that last
read it: a buffer is refilled only after that copy has finished, or the
refill would change a CPI in flight. The card tensors are allocated on the
copy stream and marked with ``record_stream`` for the compute stream, so the
caching allocator hands their memory out again only after the compute that
reads them.

Products come back the other way: :func:`start_fetch` enqueues
non-blocking copies of every output tensor into pinned host tensors behind
the CPI's work and records one event; :meth:`Fetch.wait` waits on it and
returns the outputs as NumPy arrays, so serialising them reads host memory
only; the event, a timing one, also ends the runtime's timing of the CPI
on the card. On the CPU both are plain: the tensors are already host
memory.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from blah2_tpu_torch.device import tree_map


class PinnedStager:
    """Copies NumPy wire chunks to ``device`` through rings of ``depth``
    pinned buffers per (dtype, shape), on a copy stream of its own.

    ``bytes`` and ``copies`` count what it has moved."""

    def __init__(self, device: torch.device, depth: int):
        self.device = device
        self.depth = max(1, int(depth))
        self.stream = torch.cuda.Stream(device)
        self._rings: dict = {}
        self.bytes = 0
        self.copies = 0

    def _slot(self, arr: np.ndarray) -> list:
        """The next [pinned buffer, guard event] of ``arr``'s ring, its
        last copy finished."""
        ring = self._rings.setdefault((arr.dtype.str, arr.shape),
                                      {"slots": [], "next": 0})
        slots = ring["slots"]
        if len(slots) < self.depth:
            slot = [torch.empty(arr.shape, dtype=torch.from_numpy(arr).dtype,
                                pin_memory=True), None]
            slots.append(slot)
            return slot
        slot = slots[ring["next"]]
        ring["next"] = (ring["next"] + 1) % self.depth
        if slot[1] is not None:
            slot[1].synchronize()
        return slot

    def put(self, arr: np.ndarray) -> torch.Tensor:
        """``arr`` on the card, its copy enqueued on :attr:`stream`. The
        compute stream must wait on that stream (:meth:`ready_on`) before
        it reads the result."""
        arr = np.ascontiguousarray(arr)
        slot = self._slot(arr)
        np.copyto(slot[0].numpy(), arr)
        consumer = torch.cuda.current_stream(self.device)
        with torch.cuda.stream(self.stream):
            dev = slot[0].to(self.device, non_blocking=True)
            done = torch.cuda.Event()
            done.record(self.stream)
        dev.record_stream(consumer)
        slot[1] = done
        self.bytes += arr.nbytes
        self.copies += 1
        return dev

    def ready_on(self) -> None:
        """Make the current stream wait for every copy enqueued so far, on
        the card; the host does not wait."""
        torch.cuda.current_stream(self.device).wait_stream(self.stream)


class Fetch:
    """Products on their way to the host (see :func:`start_fetch`)."""

    def __init__(self, host, event: Optional[torch.cuda.Event]):
        self._host = host
        self.event = event

    def wait(self):
        """The products as NumPy arrays, once their copies have landed."""
        if self.event is not None:
            self.event.synchronize()
        return tree_map(lambda t: t.numpy(), self._host)


def start_fetch(out, device: torch.device) -> Fetch:
    """Enqueue non-blocking copies of every tensor of ``out`` into pinned
    host tensors on the current stream, behind the work that makes them,
    and record one timing event after the last."""
    if device.type != "cuda":
        return Fetch(tree_map(lambda t: t.detach(), out), None)

    def copy(t):
        h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        h.copy_(t, non_blocking=True)
        return h

    host = tree_map(copy, out)
    event = torch.cuda.Event(enable_timing=True)
    event.record(torch.cuda.current_stream(device))
    return Fetch(host, event)


def fetch(out, device: torch.device):
    """Every product of ``out`` on the host, as NumPy arrays, in one
    batched fetch."""
    return start_fetch(out, device).wait()
