#!/usr/bin/env python3
"""Host time of a halo exchange call and of its pieces, on one NVIDIA card.

    python3 tools/torch_halo_host.py

On a 1 x 4 mesh of logical ranks on the card, times by the host clock
(many back-to-back calls, no synchronisation inside) the pieces of a call
of the halo wrapper (``blah2_tpu_torch/ops/halo.py``): the two ways to get
the current stream, the output allocation, its per-rank views, the
per-rank checks; then the whole wrapper on the (409, 2) float32 payload
and on the main path's masked, strided complex64 slices, a whole
``shift_from_next``, and four ``Tensor.copy_`` calls doing the circular
permute. Prints one JSON line of us per call, with the card's name and
power limit. It needs a card and exits 2 without one.
"""

from __future__ import annotations

import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("torch_halo_host: needs a CUDA card", file=sys.stderr)
        return 2
    import chip_smoke
    from blah2_tpu_torch.device import current_stream_handle
    from blah2_tpu_torch.ops.halo import _source, halo_permute
    from blah2_tpu_torch.parallel.halo import shift_from_next
    from blah2_tpu_torch.parallel.mesh import make_radar_mesh

    dev = torch.device("cuda", 0)
    mesh = make_radar_mesh(1, 4, devices=[dev] * 4)
    blocks = [torch.randn(1, 375_000, dtype=torch.complex64, device=dev)
              for _ in range(4)]
    parts = [b[..., :409] for b in blocks]
    bufs = [torch.randn(409, 2, device=dev) for _ in range(4)]
    dst = [torch.empty_like(b) for b in bufs]
    src = _source(mesh, "pulse", True)
    out = torch.empty((4, 1, 409), dtype=torch.complex64, device=dev)
    shape, stride = parts[0].shape, parts[0].stride()

    def us(fn, n=5000):
        for _ in range(200):
            fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        dt = time.perf_counter() - t0
        torch.cuda.synchronize()
        return dt / n * 1e6

    def copies():
        for r, s in enumerate(src):
            dst[r].copy_(bufs[s])

    result = {
        "current_stream": us(lambda: torch.cuda.current_stream(0).cuda_stream),
        "current_stream_handle": us(lambda: current_stream_handle(0)),
        "empty": us(lambda: torch.empty((4, 1, 409), dtype=torch.complex64,
                                        device=dev)),
        "unbind": us(lambda: out.unbind(0)),
        "checks": us(lambda: [b.get_device() == 0 and b.shape == shape
                              and b.stride() == stride for b in parts]),
        "copy_ x4": us(copies),
        "halo circular (409, 2) f32": us(lambda: halo_permute(bufs, mesh)),
        "halo masked strided (1, 409) c64": us(
            lambda: halo_permute(parts, mesh, mask_edge=True)),
        "shift_from_next (1, 409) c64": us(
            lambda: shift_from_next(blocks, 409, mesh, backend="pallas")),
    }
    print(json.dumps({"host_us_per_call": result,
                      "card": chip_smoke.card_line()}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
