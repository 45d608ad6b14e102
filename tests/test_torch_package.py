"""Guards on the PyTorch port as a package: it imports neither JAX nor the
JAX package, its entry points need a card unless told otherwise, and its
host-side copies (config, FFT sizes, the runtime's host layers) agree with
the JAX package's."""

from __future__ import annotations

import glob
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT_FILES = sorted(
    glob.glob(os.path.join(REPO, "blah2_tpu_torch", "**", "*.py"),
              recursive=True)
    + glob.glob(os.path.join(REPO, "blah2_tpu_torch", "csrc", "*"))
    + [os.path.join(REPO, "chip_smoke.py"),
       os.path.join(REPO, "deploy", "smoke_3proc_torch.sh")])

_PROBE = r"""
import sys
import torch
import blah2_tpu_torch
from blah2_tpu_torch.config import Config
from blah2_tpu_torch.convert import pipeline_state_to_numpy
from blah2_tpu_torch.dsp.pipeline import CpiPipeline, entry
from blah2_tpu_torch.capture.synthetic import synthetic_cpi
from blah2_tpu_torch.ops.halo import halo_permute
from blah2_tpu_torch.parallel import collectives, halo
from blah2_tpu_torch.parallel.mesh import make_radar_mesh
from blah2_tpu_torch.parallel.sharded import (ShardedCpiPipeline,
                                              calibrate_row_shard)
from blah2_tpu_torch.runtime import cli, radar
from blah2_tpu_torch.runtime.radar import RadarRuntime
from blah2_tpu_torch.net.api import ApiServer
from blah2_tpu_torch.bench import (common, compare, pipeline, projection,
                                   runtime, scaling, soak, soak_supervised)
from blah2_tpu_torch import entry
pipe = CpiPipeline(Config(), device="cpu")
RadarRuntime(Config(), device="cpu", staged_sample_every=0)
pipeline_state_to_numpy(pipe)
sharded = ShardedCpiPipeline(Config(), make_radar_mesh(
    1, 4, devices=["cpu"] * 4), halo_backend="pallas")
pipeline_state_to_numpy(sharded)
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.") or m == "blah2_tpu"
             or m.startswith("blah2_tpu."))
print("BAD=" + ",".join(bad))
"""


#: The host layers the port keeps its own copies of: each equals its
#: original in blah2_tpu/ but for the renames of ``_renamed``.
HOST_COPIES = [
    "constants.py", "utils/__init__.py", "utils/jsonfmt.py",
    "data/__init__.py", "data/iq.py", "data/ddmap.py", "data/detection.py",
    "data/track.py", "data/timing.py", "tracker/__init__.py",
    "tracker/tracker.py", "native.py", "capture/__init__.py",
    "capture/source.py", "capture/replay.py", "capture/drivers.py",
    "capture/capture.py", "capture/synthetic.py",
    "capture/vendor/__init__.py", "capture/vendor/hackrf.py",
    "capture/vendor/rtlsdr.py", "capture/vendor/sdrplay.py",
    "capture/vendor/uhd.py", "net/__init__.py", "net/socket.py",
    "net/stash.py", "net/api.py"]


def _renamed(text: str) -> str:
    """A JAX-package source as the port's copy of it: module paths
    ``blah2_tpu.`` and ``from blah2_tpu import`` name the port, and a
    citation of the reference's C++ sources by an absolute checkout path
    cites ``src/...`` as the rest of the port does."""
    text = re.sub(r"(?<![\w.])blah2_tpu\.", "blah2_tpu_torch.", text)
    text = re.sub(r"`/\w+/reference/src/", "`src/", text)
    return re.sub(r"\bfrom blah2_tpu import\b", "from blah2_tpu_torch import",
                  text)


@pytest.mark.parametrize("rel", HOST_COPIES)
def test_host_copy_equals_its_original(rel):
    with open(os.path.join(REPO, "blah2_tpu", rel), encoding="utf-8") as f:
        original = f.read()
    with open(os.path.join(REPO, "blah2_tpu_torch", rel),
              encoding="utf-8") as f:
        copy = f.read()
    assert copy == _renamed(original)


def test_port_imports_no_jax_and_no_jax_package():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    proc = subprocess.run([sys.executable, "-c", _PROBE], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    line = [ln for ln in proc.stdout.splitlines() if ln.startswith("BAD=")]
    assert line == ["BAD="], proc.stdout


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=[os.path.relpath(p, REPO) for p in PORT_FILES])
def test_port_sources_never_name_jax(path):
    """No port source imports JAX or names a JAX-package module
    (``blah2_tpu.``); counterparts are cited by path (``blah2_tpu/...``)."""
    with open(path, encoding="utf-8") as f:
        text = f.read()
    assert "import jax" not in text
    assert not re.search(r"^\s*from\s+jax\b", text, re.M)
    assert "blah2_tpu." not in text


def test_entry_points_need_a_card_unless_told():
    from blah2_tpu_torch.config import Config
    from blah2_tpu_torch.dsp.pipeline import CpiPipeline
    from blah2_tpu_torch.ops.detect import FusedDetector

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        CpiPipeline(Config())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        FusedDetector(1e-3, 2, 6, 5, 6.0, 6, 6, 2.0, np.arange(40),
                      np.arange(-8, 8, dtype=np.float64))
    pipe = CpiPipeline(Config(), device="cpu")
    assert pipe.device.type == "cpu"
    assert pipe.ambiguity._doppler_dft.device.type == "cpu"


def test_device_helpers():
    from blah2_tpu_torch.device import complex_of_parts, real_dtype

    assert real_dtype(torch.complex64) == torch.float32
    assert real_dtype(torch.complex128) == torch.float64
    with pytest.raises(ValueError):
        real_dtype(torch.float32)
    re_ = torch.tensor([1, -2048, 2047], dtype=torch.int16)
    im_ = torch.tensor([0, 5, -7], dtype=torch.int32)
    for dt in (torch.complex64, torch.complex128):
        z = complex_of_parts(re_, im_, dt)
        assert z.dtype == dt
        np.testing.assert_array_equal(z.numpy(),
                                      np.array([1, -2048 + 5j, 2047 - 7j]))


@pytest.mark.parametrize("name", sorted(
    os.path.basename(p) for p in glob.glob(os.path.join(REPO, "config",
                                                        "*.yml"))))
def test_config_copy_matches_jax_package(name):
    import dataclasses

    from blah2_tpu.config import load_config as load_jax
    from blah2_tpu_torch.config import load_config as load_port

    path = os.path.join(REPO, "config", name)
    assert dataclasses.asdict(load_port(path)) == \
        dataclasses.asdict(load_jax(path))


def test_default_config_is_config_yml():
    import dataclasses

    from blah2_tpu_torch.config import Config, load_config

    a = dataclasses.asdict(load_config(os.path.join(REPO, "config",
                                                    "config.yml")).process)
    b = dataclasses.asdict(Config().process)
    assert a == b


def test_hamming_golden_and_fft_size():
    from blah2_tpu.dsp.hamming import next_hamming as jax_next
    from blah2_tpu_torch.dsp.hamming import (is_hamming, next_fft_size,
                                             next_hamming)

    assert next_hamming(104) == 108
    assert next_hamming(3322) == 3375
    assert next_hamming(9965) == 10000
    assert next_hamming(19043) == 19200
    for v in list(range(1, 3000)) + [9965, 16034, 1_500_410]:
        assert next_hamming(v) == jax_next(v)
        f = next_fft_size(v)
        assert f >= v and is_hamming(f)
        assert f == v or next_hamming(v) == f  # smallest: inclusive
    assert next_fft_size(10000) == 10000
    assert not is_hamming(0) and not is_hamming(7) and is_hamming(6750)


def test_segment_fft_size_swaps_on_the_card():
    """The card replaces the 16,200-point clutter segments of the default
    config with 16,384 points (measured: PERF.md, Findings); the CPU keeps
    the 5-smooth pick, and so do the sharded paths' sizes."""
    from blah2_tpu_torch.dsp.hamming import next_fft_size, segment_fft_size

    assert segment_fft_size(16_034, "cpu") == 16_200
    assert segment_fft_size(16_034, "cuda") == 16_384
    for need in (17_623, 23_210, 5_000, 16_201):
        assert segment_fft_size(need, "cuda") == next_fft_size(need) == \
            segment_fft_size(need, "cpu")
