"""A CPI entry over static buffers, captured as a CUDA graph and replayed:
the port's counterpart of JAX's compiled CPI.

The JAX package never runs a CPI as a stream of separate operations: it
compiles the CPI into one XLA program per input layout and dispatches that
program once (``blah2_tpu/dsp/pipeline.py:205-226``, and one program per
chunk count at ``:339-361``; NLMS's recursion is one ``lax.scan``, one
device loop). Eager PyTorch enqueues each kernel from Python: about 220 a
default CPI, about 29,500 an NLMS CPI. A :class:`StaticCall` records them
once and replays them with one launch.

:class:`StaticCall` holds one static device buffer per input, of the
input's shape and dtype. A call copies the inputs into the buffers on the
current stream, then either runs the body on them (eager: what the tests
run on the CPU, the function the graph records) or, once :meth:`capture`
has recorded the body on a card, replays the graph on the current stream.
The outputs of a replay are cloned, so no later replay changes what an
earlier call returned.

:meth:`capture` runs the body once eagerly on a capture stream of its own
(that call loads the kernel modules, creates the cuFFT plans and the
cuSOLVER handle, and lays out the detect kernel's scratch for that stream)
under ``torch.cuda.set_sync_debug_mode("error")``, so a hidden host sync
raises there, named by its line; then it captures the body in the global
capture mode. A capture that fails raises :class:`GraphCaptureError` with
the line of the package that failed; nothing falls back to eager.

The kernel wrappers count their Python calls, and the collectives log
what they move on their mesh (``parallel/collectives.py`` ``count_bytes``).
A capture runs the body's Python without launching anything, and a replay
runs no Python: so the graph keeps what its capture counted and logged,
takes it back from the counts and the open logs (:meth:`StaticCall.record`),
and adds it on every replay. A replay then counts and logs what an eager
call of the body would. Each wrapper that counts registers itself in
:data:`COUNTERS` (``snapshot()``: its counts by name; ``add(delta,
sign)``); this module names none of them.

A body that is a bound method is held weakly, so the owner of a graph (a
pipeline, which holds its graphs) and the graph form no reference cycle:
a dropped pipeline frees its graphs' memory at once, not when the cyclic
collector runs.

The sharded step (``parallel/sharded.py``) takes the same class: its inputs
are the per-rank planes flattened, None at the ranks of another process,
and its products a tree of NamedTuples.

Several cards: a body whose inputs lie on several cards is captured as one
graph over them, as one XLA program spans a mesh. Each input buffer lies on
its input's card (a host input's on the home card). The warm-up and the
capture run on one stream per card, each made the current stream of its
card, so that the body's launches and cross-card copies (which order the
two cards' current streams by events) all land in the capture: the other
cards' streams are forked from the home card's capture stream by events and
joined back into it before the capture ends. The warm-up lays out the
kernels' scratch on those very streams. PyTorch gives a capture's private
memory pool to the capture card alone; each other card's intermediates go
to a ``torch.cuda.MemPool`` of the graph's own for the capture (held while
the graph lives), so no later allocation on that card takes memory that a
replay still writes. A replay runs on the home card's current stream, after
every card's current stream (where the inputs were copied in), and every
card's current stream then waits for it.
"""

from __future__ import annotations

import contextlib
import gc
import os
import time
import traceback
import types
import weakref
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from blah2_tpu_torch.device import tree_map

_PACKAGE_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class GraphCaptureError(RuntimeError):
    """A CUDA graph capture of a CPI entry failed."""


def as_tensor(a) -> torch.Tensor:
    """A NumPy array or tensor as a tensor where it lies (NumPy on the
    host)."""
    if isinstance(a, np.ndarray):
        return torch.from_numpy(np.ascontiguousarray(a))
    return torch.as_tensor(a)


def _failing_line(exc: BaseException) -> str:
    """The innermost line of this package in ``exc``'s traceback, as
    ``path:line (code)``, or the innermost line at all."""
    frames = traceback.extract_tb(exc.__traceback__)
    ours = [f for f in frames if f.filename.startswith(_PACKAGE_DIR)
            and not f.filename.endswith(os.sep + "graph.py")]
    f = (ours or frames or [None])[-1]
    if f is None:
        return "an unknown line"
    path = os.path.relpath(f.filename, os.path.dirname(_PACKAGE_DIR))
    return f"{path}:{f.lineno} ({(f.line or '').strip()})"


#: The kernel wrappers' counters: each has ``snapshot()``, its counts by
#: name (names unique across the list), and ``add(delta, sign)``, which adds
#: ``sign`` times its names' entries of ``delta``. Wrappers register at
#: import.
COUNTERS: list = []


def counts() -> dict:
    """The registered wrappers' counts by name."""
    out: dict = {}
    for counter in COUNTERS:
        out.update(counter.snapshot())
    return out


def add_counts(delta: dict, sign: int = 1) -> None:
    """Add ``sign`` times ``delta`` (names of :func:`counts`) to the
    wrappers' counts."""
    for counter in COUNTERS:
        counter.add(delta, sign)


class StaticCall:
    """``body(*buffers)`` over static input buffers, each made like its
    input of ``inputs`` on the input's device, a host input's on
    ``device`` (None where an input is None); eager until :meth:`capture`,
    a graph replay after. ``device``: the home card, where the graph is
    launched. A bound method ``body`` is held weakly.

    ``meshes``: the meshes whose collective logs the body appends to.
    ``counts``: what one replay adds to :func:`counts` (names whose count
    moves); ``ops``: what it appends to each mesh's open log.
    ``replays``: the replays so far; ``released``: :meth:`release` freed
    the graph.
    ``cards``: the home device, then the other devices of the inputs.
    ``stream``: the capture's stream on the home card; ``streams``: the
    capture's stream of each card by index, on which the warm-up laid out
    the kernels' scratch that the graph's launches use.
    ``capture_error_mode``: ``torch.cuda.graph``'s; "thread_local" where
    another thread of the process makes CUDA calls throughout (NCCL's
    watchdog).
    ``stats``: the capture's ``warmup_ms``, ``capture_ms`` and
    ``instantiate_ms`` (host wall)."""

    def __init__(self, body: Callable,
                 inputs: Sequence[Optional[torch.Tensor]],
                 device: torch.device, name: str = "cpi",
                 meshes: Sequence = (),
                 capture_error_mode: str = "global"):
        self._body = weakref.WeakMethod(body) \
            if isinstance(body, types.MethodType) else lambda: body
        self.device = device
        self.name = name
        self.meshes = tuple(meshes)
        self.capture_error_mode = capture_error_mode
        # A host input's buffer lies on the home device: the call copies
        # it in.
        self.inputs = [None if t is None else torch.empty(
            t.shape, dtype=t.dtype,
            device=device if t.device.type == "cpu" else t.device)
            for t in inputs]
        self.cards = [device] + list(dict.fromkeys(
            b.device for b in self.inputs
            if b is not None and b.device != device))
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.outputs = None
        self.stream = None
        self.streams: dict = {}
        self._pools: list = []
        self.replays = 0
        self.released = False
        self.counts: dict = {}
        self.ops: list = [[] for _ in self.meshes]
        self.stats: dict = {}

    @property
    def body(self) -> Callable:
        body = self._body()
        if body is None:
            raise ReferenceError(f"{self.name}: the body's owner is gone")
        return body

    def _load(self, inputs) -> None:
        if len(inputs) != len(self.inputs):
            raise ValueError(f"{self.name}: {len(inputs)} inputs, the "
                             f"graph holds {len(self.inputs)}")
        for buf, t in zip(self.inputs, inputs):
            if buf is None or t is None:
                if buf is not t:
                    raise ValueError(f"{self.name}: the inputs are None at "
                                     f"other places than the buffers")
                continue
            if tuple(t.shape) != tuple(buf.shape) or t.dtype != buf.dtype:
                raise ValueError(
                    f"{self.name}: input {tuple(t.shape)} {t.dtype}, the "
                    f"buffer is {tuple(buf.shape)} {buf.dtype}")
            buf.copy_(t, non_blocking=True)

    def __call__(self, *inputs):
        """The body's outputs for ``inputs``: run eagerly on the buffers,
        or the graph replayed, what it counts added and its outputs
        cloned."""
        if self.released:
            raise ReferenceError(f"{self.name}: the graph was freed at "
                                 f"shutdown")
        self._load(inputs)
        if self.graph is None:
            return self.body(*self.inputs)
        self._replay()
        self.replays += 1
        add_counts(self.counts)
        for mesh, ops in zip(self.meshes, self.ops):
            if mesh.comm_log is not None:
                mesh.comm_log.extend(ops)
        return tree_map(torch.clone, self.outputs)

    def release(self) -> None:
        """Free the graph, its outputs and its pools; a later call raises
        ``ReferenceError``."""
        self.graph = self.outputs = None
        self._pools = []
        self.released = True

    def _replay(self) -> None:
        """The graph on the home card's current stream, ordered after
        every card's current stream and before their next work."""
        others = self.cards[1:]
        if not others:
            self.graph.replay()
            return
        with torch.cuda.device(self.device):
            home = torch.cuda.current_stream(self.device)
            for d in others:
                home.wait_stream(torch.cuda.current_stream(d))
            self.graph.replay()
            for d in others:
                torch.cuda.current_stream(d).wait_stream(home)

    @contextlib.contextmanager
    def _on_streams(self):
        """Each card's capture stream its current stream (the home card's
        last, so that it is the current device)."""
        with contextlib.ExitStack() as stack:
            for d in reversed(self.cards):
                stack.enter_context(torch.cuda.stream(self.streams[d.index]))
            yield

    def record(self, fn: Callable):
        """``fn()`` (the body under capture), what it counts kept for the
        replays: the wrappers' counts it moved, taken back, and the
        collectives it logged on :attr:`meshes`, kept out of the logs open
        there."""
        before = counts()
        saved = [mesh.comm_log for mesh in self.meshes]
        self.ops = [[] for _ in self.meshes]
        for mesh, log in zip(self.meshes, self.ops):
            mesh.comm_log = log
        try:
            return fn()
        finally:
            self.counts = {k: v - before[k] for k, v in counts().items()
                           if v != before[k]}
            add_counts(self.counts, -1)
            for mesh, log in zip(self.meshes, saved):
                mesh.comm_log = log

    def capture(self, *inputs):
        """Warm up and capture the body on streams of its own, one a
        card; later calls replay. Returns the warm-up call's outputs, the
        products of ``inputs``."""
        dev = self.device
        if any(d.type != "cuda" for d in self.cards):
            raise ValueError(f"{self.name}: a CUDA graph needs a card, the "
                             f"buffers are on "
                             f"{', '.join(map(str, self.cards))}")
        t0 = time.perf_counter()
        callers = {d.index: torch.cuda.current_stream(d) for d in self.cards}
        self.streams = {d.index: torch.cuda.Stream(d) for d in self.cards}
        self.stream = stream = self.streams[dev.index]
        for d in self.cards:
            self.streams[d.index].wait_stream(callers[d.index])
            self.streams[d.index].wait_stream(callers[dev.index])
        with self._on_streams():
            self._load(inputs)
            mode = torch.cuda.get_sync_debug_mode()
            torch.cuda.set_sync_debug_mode("error")
            try:
                warm = self.body(*self.inputs)
            finally:
                torch.cuda.set_sync_debug_mode(mode)
        for d in self.cards:
            callers[d.index].wait_stream(self.streams[d.index])
        # The warm-up's outputs were made on the capture streams: keep their
        # memory from new work there until the callers' streams are done.
        tree_map(lambda t: t.record_stream(torch.cuda.current_stream(
            t.device)), warm)
        t1 = time.perf_counter()

        graph = torch.cuda.CUDAGraph(keep_graph=True)
        failed: list = []
        others = [self.streams[d.index] for d in self.cards[1:]]

        def body():
            try:
                # Fork the other cards' streams into the capture, and join
                # them back before it ends.
                for s in others:
                    s.wait_stream(stream)
                out = self.body(*self.inputs)
                for s in others:
                    stream.wait_stream(s)
                return out
            except BaseException as e:
                failed.append(e)
                raise

        # The other cards' intermediates: a pool of the graph's own on
        # each, made with that card current.
        self._pools = []
        for d in self.cards[1:]:
            with torch.cuda.device(d):
                self._pools.append((d, torch.cuda.MemPool()))

        # Python's collector must not run inside the capture: a cycle it
        # frees may hold device memory of the package's own (a halo plan's
        # cudaMalloc'ed window), whose cudaFree the global capture mode
        # forbids. Hold it off until the capture ends.
        collecting = gc.isenabled()
        gc.disable()
        try:
            with contextlib.ExitStack() as stack:
                for d, pool in self._pools:
                    stack.enter_context(torch.cuda.use_mem_pool(pool,
                                                                device=d))
                stack.enter_context(self._on_streams())
                stack.enter_context(torch.cuda.graph(
                    graph, stream=stream,
                    capture_error_mode=self.capture_error_mode))
                outputs = self.record(body)
        except Exception as e:
            cause = failed[0] if failed else e
            raise GraphCaptureError(
                f"CUDA graph capture of {self.name} failed at "
                f"{_failing_line(cause)}: {cause}") from cause
        finally:
            if collecting:
                gc.enable()
        t2 = time.perf_counter()
        graph.instantiate()
        t3 = time.perf_counter()
        self.graph, self.outputs = graph, outputs
        self.stats = {"warmup_ms": (t1 - t0) * 1e3,
                      "capture_ms": (t2 - t1) * 1e3,
                      "instantiate_ms": (t3 - t2) * 1e3}
        return warm
