"""The port's CUDA kernel against its plain version, on the card.

These tests import no JAX, so they also run where JAX is not installed:

    python -m pytest tests/test_torch_cuda.py -q --noconftest

Without a CUDA device they skip: a CUDA kernel has no CPU mode.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from blah2_tpu_torch.dsp.ambiguity import AmbiguityProcessor
from blah2_tpu_torch.ops import detect as tdetect
from blah2_tpu_torch.ops.detect import FusedDetector, detect_plain

torch.set_num_threads(1)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda", 0)


def _map(nr, nc, seed, targets=()):
    rng = np.random.default_rng(seed)
    z = (rng.standard_normal((nr, nc))
         + 1j * rng.standard_normal((nr, nc))).astype(np.complex64)
    for r, c, a in targets:
        z[r, c] += a
    return z


def _tie_map():
    z = np.full((16, 40), 0.05 + 0j, dtype=np.complex64)
    z[8, 20] = z[8, 25] = 50.0
    return z


def _cases():
    amb = AmbiguityProcessor(-10, 400, -200, 200, 2_000_000, 1_500_000,
                             device="cpu")
    default = (1e-5, 2, 6, 5, 15.0, 6, 6, 1 / 0.75, amb.delay_axis,
               amb.doppler_axis)
    loose = (1e-2, 1, 3, 0, 0.0, 6, 6, 2.0)
    half = 8
    tie_axes = (np.arange(-10, 30, dtype=np.int32),
                2.0 * np.arange(-half, 16 - half, dtype=np.float64))
    return {
        "default-targets": (_map(301, 411, 3, [(150, 200, 80.0),
                                               (40, 30, 60.0)]), default),
        "default-overflow": (_map(301, 411, 4), loose[:8] + (
            amb.delay_axis, amb.doppler_axis)),
        "tie": (_tie_map(), loose + tie_axes),
    }


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["default-targets", "default-overflow",
                                  "tie"])
def test_kernel_matches_plain_on_card(card, name):
    """csrc/detect.cu against detect_plain on the same card tensors."""
    z, args = _cases()[name]
    fd = FusedDetector(*args, device=card)
    zc = torch.from_numpy(z).to(card)
    pwr = (zc.real * zc.real + zc.imag * zc.imag).contiguous()
    kw = (fd._scale, fd._cell_ok, fd.n_guard, fd.n_train, fd.win_rows,
          fd.win_cols)
    launches = tdetect.detect.launches
    got = tdetect.detect(pwr, *kw)
    torch.cuda.synchronize()
    assert tdetect.detect.launches == launches + 1
    want = detect_plain(pwr, *kw)
    assert torch.equal(got.keep, want.keep)
    assert float((got.db - want.db).abs().max()) <= 1e-4
    assert abs(float(got.noise - want.noise)) <= 1e-4
    assert abs(float(got.rawmax - want.rawmax)) <= 1e-4
    # The same noise on every run: no float atomics.
    again = tdetect.detect(pwr, *kw)
    assert torch.equal(again.noise, got.noise)
    if name == "tie":
        _, _, _, det = fd(zc)
        assert sorted(det.col[det.valid].tolist()) == [20, 25]


@pytest.mark.cuda
def test_kernel_rejects_what_it_does_not_take(card):
    pwr = torch.ones(4, 6, device=card)
    scale = torch.ones(1, 6, device=card)
    with pytest.raises(TypeError, match="float32"):
        tdetect.detect(pwr.double(), scale, pwr, 1, 2, 1, 1)
    with pytest.raises(ValueError, match="contiguous"):
        tdetect.detect(pwr, scale, torch.ones(6, 4, device=card).t(), 1, 2,
                       1, 1)
    with pytest.raises(ValueError, match="is on"):
        tdetect.detect(pwr, scale.cpu(), pwr, 1, 2, 1, 1)
