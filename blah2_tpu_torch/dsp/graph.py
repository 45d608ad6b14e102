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

The detect kernel's wrapper counts Python calls. A replay makes none, so
the graph keeps the launches its capture recorded and adds them to the
wrapper's counts on every replay; the capture, which launches nothing,
takes its own back.
"""

from __future__ import annotations

import gc
import os
import time
import traceback
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from blah2_tpu_torch.device import tree_map
from blah2_tpu_torch.ops.detect import detect

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


def _counts() -> tuple:
    return detect.launches, detect.row_launches


class StaticCall:
    """``body(*buffers)`` over static input buffers on ``device``, made
    like ``inputs``; eager until :meth:`capture`, a graph replay after.

    ``launches``: the detect kernel's (launches, row-block launches) that
    one replay makes. ``stats``: the capture's ``warmup_ms``,
    ``capture_ms`` and ``instantiate_ms`` (host wall)."""

    def __init__(self, body: Callable, inputs: Sequence[torch.Tensor],
                 device: torch.device, name: str = "cpi"):
        self.body = body
        self.device = device
        self.name = name
        self.inputs = [torch.empty(t.shape, dtype=t.dtype, device=device)
                       for t in inputs]
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.outputs = None
        self.stream = None
        self.scratch = None
        self.launches = (0, 0)
        self.stats: dict = {}

    def _load(self, inputs) -> None:
        if len(inputs) != len(self.inputs):
            raise ValueError(f"{self.name}: {len(inputs)} inputs, the "
                             f"graph holds {len(self.inputs)}")
        for buf, t in zip(self.inputs, inputs):
            if tuple(t.shape) != tuple(buf.shape) or t.dtype != buf.dtype:
                raise ValueError(
                    f"{self.name}: input {tuple(t.shape)} {t.dtype}, the "
                    f"buffer is {tuple(buf.shape)} {buf.dtype}")
            buf.copy_(t, non_blocking=True)

    def __call__(self, *inputs):
        """The body's outputs for ``inputs``: run eagerly on the buffers,
        or the graph replayed and its outputs cloned."""
        self._load(inputs)
        if self.graph is None:
            return self.body(*self.inputs)
        self.graph.replay()
        detect.add_launches(*self.launches)
        return tree_map(torch.clone, self.outputs)

    def capture(self, *inputs):
        """Warm up and capture the body on a stream of its own; later
        calls replay. Returns the warm-up call's outputs, the products of
        ``inputs``."""
        dev = self.device
        if dev.type != "cuda":
            raise ValueError(f"{self.name}: a CUDA graph needs a card, the "
                             f"buffers are on {dev}")
        t0 = time.perf_counter()
        self.stream = stream = torch.cuda.Stream(dev)
        current = torch.cuda.current_stream(dev)
        stream.wait_stream(current)
        with torch.cuda.stream(stream):
            self._load(inputs)
            mode = torch.cuda.get_sync_debug_mode()
            torch.cuda.set_sync_debug_mode("error")
            try:
                warm = self.body(*self.inputs)
            finally:
                torch.cuda.set_sync_debug_mode(mode)
        current.wait_stream(stream)
        # The warm-up's outputs were made on the capture stream: keep their
        # memory from new work there until the caller's stream is done.
        tree_map(lambda t: t.record_stream(current), warm)
        # The detect kernel's counters and partials on this stream, laid
        # out by the warm-up; the graph's launches use them.
        self.scratch = detect.scratch(dev.index, stream.cuda_stream)
        t1 = time.perf_counter()

        graph = torch.cuda.CUDAGraph(keep_graph=True)
        before = _counts()
        failed: list = []
        # Python's collector must not run inside the capture: a cycle it
        # frees may hold device memory of the package's own (a halo plan's
        # cudaMalloc'ed window), whose cudaFree the global capture mode
        # forbids. Hold it off until the capture ends.
        collecting = gc.isenabled()
        gc.disable()
        try:
            with torch.cuda.graph(graph, stream=stream):
                try:
                    outputs = self.body(*self.inputs)
                except BaseException as e:
                    failed.append(e)
                    raise
        except Exception as e:
            cause = failed[0] if failed else e
            raise GraphCaptureError(
                f"CUDA graph capture of {self.name} failed at "
                f"{_failing_line(cause)}: {cause}") from cause
        finally:
            if collecting:
                gc.enable()
            held = tuple(a - b for a, b in zip(_counts(), before))
            detect.add_launches(*(-h for h in held))
        t2 = time.perf_counter()
        graph.instantiate()
        t3 = time.perf_counter()
        self.graph, self.outputs, self.launches = graph, outputs, held
        self.stats = {"warmup_ms": (t1 - t0) * 1e3,
                      "capture_ms": (t2 - t1) * 1e3,
                      "instantiate_ms": (t3 - t2) * 1e3}
        return warm
