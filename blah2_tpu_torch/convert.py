"""The pipeline's state to and from NumPy.

The radar has no weights. Its state is the set of constants each stage
derives from the config: the Doppler DFT matrix and pre-shift ramp, the
spectrum twiddle and permutation, the CFAR scale and cell masks, and the
delay and Doppler axes. In the port they are registered buffers of the
stage modules, so ``CpiPipeline.state_dict()`` holds them, keyed by the same
attribute paths as the JAX ``CpiPipeline`` (``ambiguity._doppler_dft``,
``fused_detector._scale``, ...; with ``process.spectrum.nSub`` > 1 the sub
analyser's ``spectrum_sub._twiddle`` and ``spectrum_sub._perm``; with
``cfar: os`` the OS-CFAR multipliers and ranks ``cfar._alpha`` and
``cfar._k_idx``; with ``filter: eca-b`` the edge window
``clutter._edge_mask``). Buffers the port derives for itself (lag and
permutation indices) are not part of it. The sharded pipeline's
``state_dict()`` adds its own derived constants under the JAX
``ShardedCpiPipeline``'s names: the padded Doppler operator ``_w_pad``, the
padded pre-shift ramp ``_ramp_pad`` (where the Doppler window is off
centre), the padded fold twiddle ``_spec_tw_pad``, the per-segment sub-CPI
fold twiddles ``_sub_tw_pad`` (nSub > 1) and ECA-B's ``_eca_edge_mask``.
"""

from __future__ import annotations

import numpy as np
import torch

from blah2_tpu_torch.device import resolve_device


def pipeline_state_to_numpy(pipe) -> dict:
    """Every state constant of ``pipe`` as a host array, by attribute path."""
    return {k: v.detach().cpu().numpy() for k, v in pipe.state_dict().items()}


def pipeline_state_from_numpy(arrays: dict, device=None) -> dict:
    """Host arrays keyed by attribute path as tensors on ``device``, ready
    for ``CpiPipeline.load_state_dict``, which checks every key and shape
    and casts to each buffer's dtype."""
    dev = resolve_device(device)
    return {k: torch.from_numpy(np.array(v, order="C", copy=True)).to(dev)
            for k, v in arrays.items()}
