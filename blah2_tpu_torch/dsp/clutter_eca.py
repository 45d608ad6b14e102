"""Clutter canceller factory (counterpart of
``blah2_tpu/dsp/clutter_eca.py::make_clutter_filter``).

Only the reference algorithm, Wiener-Hopf, is ported so far. ECA-B and NLMS
are ROADMAP queue 1, item "Alternative algorithms".
"""

from __future__ import annotations

import torch

from blah2_tpu_torch.dsp.clutter import WienerHopfFilter


def make_clutter_filter(clutter_cfg, n_samples: int,
                        dtype: torch.dtype = torch.complex64,
                        mode: str = "circular", diag_load: float = 0.0,
                        device=None) -> WienerHopfFilter:
    """Factory keyed on ``process.clutter.filter``: "wiener" (reference
    algorithm, default); "eca-b" and "nlms" are not ported yet."""
    kind = getattr(clutter_cfg, "filter", "wiener") or "wiener"
    kind = kind.lower().replace("_", "-")
    if kind in ("wiener", "wiener-hopf", "wienerhopf"):
        return WienerHopfFilter(
            clutter_cfg.delay_min, clutter_cfg.delay_max, n_samples,
            diag_load=diag_load, dtype=dtype, mode=mode, device=device)
    if kind in ("eca-b", "ecab", "eca", "nlms"):
        raise NotImplementedError(
            f"clutter filter {kind!r} is not ported to blah2_tpu_torch yet "
            f"(ROADMAP.md queue 1: 'Alternative algorithms')")
    raise ValueError(f"unknown clutter filter {kind!r}")
