"""The port's wire decode, Toeplitz build, segmented correlation and FIR,
and spectrum against the JAX package on the same NumPy inputs."""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from blah2_tpu.dsp.spectrum import SpectrumAnalyser as JaxSpectrum
from blah2_tpu.ops import corr as jcorr
from blah2_tpu.ops import pack12 as jpack
from blah2_tpu.ops.toeplitz import hermitian_toeplitz as jax_toeplitz
from blah2_tpu_torch.dsp.spectrum import SpectrumAnalyser
from blah2_tpu_torch.ops import corr as tcorr
from blah2_tpu_torch.ops import pack12 as tpack
from blah2_tpu_torch.ops.toeplitz import hermitian_toeplitz

torch.set_num_threads(1)


def _rand_c(rng, *shape):
    return rng.standard_normal(shape) + 1j * rng.standard_normal(shape)


# -- pack12: bit-exact --------------------------------------------------------

def test_pack12_bit_exact_against_jax():
    rng = np.random.default_rng(0)
    v = rng.integers(tpack.MIN12, tpack.MAX12 + 1, size=20_000).astype(np.int16)
    v[:4] = [tpack.MIN12, tpack.MAX12, 0, -1]
    p = tpack.pack12(v)
    np.testing.assert_array_equal(p, jpack.pack12(v))
    np.testing.assert_array_equal(tpack.unpack12_np(p, v.size),
                                  jpack.unpack12_np(p, v.size))
    got = tpack.unpack12(torch.from_numpy(p), v.size)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(jpack.unpack12(p, v.size)))
    np.testing.assert_array_equal(got.numpy(), v.astype(np.int32))


def test_pack12_quads_planes_and_components():
    rng = np.random.default_rng(1)
    quads = rng.integers(-2048, 2048, size=(500, 4)).astype(np.int16)
    pq = tpack.pack12_quads(quads)
    np.testing.assert_array_equal(pq, jpack.pack12_quads(quads))
    parts = tpack.unpack12_quads(torch.from_numpy(pq), 500)
    for k, part in enumerate(parts):
        np.testing.assert_array_equal(part.numpy(), quads[:, k])
    planes = quads[:, :2]
    pp = tpack.pack12_planes(planes)
    np.testing.assert_array_equal(pp, jpack.pack12_planes(planes))
    re_, im_ = tpack.unpack_components(torch.from_numpy(pp))
    jre, jim = jpack.unpack_components(jnp.asarray(pp))
    np.testing.assert_array_equal(re_.numpy(), np.asarray(jre))
    np.testing.assert_array_equal(im_.numpy(), np.asarray(jim))
    re_, im_ = tpack.unpack_components(torch.from_numpy(planes))
    np.testing.assert_array_equal(re_.numpy(), planes[:, 0])
    np.testing.assert_array_equal(im_.numpy(), planes[:, 1])


def test_pack12_rejects_what_jax_rejects():
    with pytest.raises(ValueError, match="12-bit"):
        tpack.pack12(np.array([0, 4096], dtype=np.int16))
    with pytest.raises(ValueError, match="even"):
        tpack.pack12(np.array([1, 2, 3], dtype=np.int16))
    with pytest.raises(ValueError, match="even"):
        tpack.unpack12(torch.zeros(3, dtype=torch.uint8), 3)
    with pytest.raises(ValueError, match="uint8"):
        tpack.unpack12(torch.zeros(3, dtype=torch.int16), 2)


# -- Toeplitz -------------------------------------------------------------------

@pytest.mark.parametrize("nb", [1, 2, 3, 16, 411])
def test_hermitian_toeplitz_matches_jax(nb):
    a = _rand_c(np.random.default_rng(nb), nb).astype(np.complex64)
    np.testing.assert_array_equal(
        hermitian_toeplitz(torch.from_numpy(a)).numpy(),
        np.asarray(jax_toeplitz(jnp.asarray(a))))


# -- segmented correlation and FIR ---------------------------------------------

def test_choose_segments_matches_jax():
    for n, m, k in [(1_500_000, 92, 1), (1_500_000, 16, 8), (1 << 20, 16, 4),
                    (1031, 2, 2), (20_000, 16, 1)]:
        assert tcorr.choose_segments(n, m, k) == jcorr.choose_segments(n, m, k)


@pytest.mark.parametrize("circular", [True, False])
@pytest.mark.parametrize("batch", [(), (3,)])
def test_segmented_circular_corr_matches_jax(circular, batch):
    rng = np.random.default_rng(2)
    n, nb, n_seg = 4096, 37, 8
    x, y = _rand_c(rng, *batch, n), _rand_c(rng, *batch, n)
    got = tcorr.segmented_circular_corr(torch.from_numpy(y),
                                        torch.from_numpy(x), nb, n_seg,
                                        circular=circular).numpy()
    want = np.asarray(jcorr.segmented_circular_corr(
        jnp.asarray(y), jnp.asarray(x), nb, n_seg, circular=circular))
    np.testing.assert_allclose(got, want, rtol=1e-9, atol=1e-9)
    if circular and not batch:
        ref = np.fft.ifft(np.fft.fft(y) * np.conj(np.fft.fft(x)))[:nb]
        np.testing.assert_allclose(got, ref, rtol=1e-9, atol=1e-9)


def test_segmented_fir_and_halos_match_jax():
    rng = np.random.default_rng(3)
    n, nb, n_seg = 2048, 21, 8
    x, w = _rand_c(rng, n), _rand_c(rng, nb)
    got = tcorr.segmented_fir(torch.from_numpy(w), torch.from_numpy(x),
                              n_seg).numpy()
    want = np.asarray(jcorr.segmented_fir(jnp.asarray(w), jnp.asarray(x),
                                          n_seg))
    np.testing.assert_allclose(got, want, rtol=1e-9, atol=1e-9)
    np.testing.assert_allclose(got, np.convolve(w, x)[:n], rtol=1e-9,
                               atol=1e-9)
    for circ in (True, False):
        np.testing.assert_array_equal(
            tcorr._right_halo_segments(torch.from_numpy(x), n_seg, nb - 1,
                                       circular=circ).numpy(),
            np.asarray(jcorr._right_halo_segments(jnp.asarray(x), n_seg,
                                                  nb - 1, circular=circ)))
    np.testing.assert_array_equal(
        tcorr._left_halo_segments_linear(torch.from_numpy(x), n_seg,
                                         nb - 1).numpy(),
        np.asarray(jcorr._left_halo_segments_linear(jnp.asarray(x), n_seg,
                                                    nb - 1)))


# -- spectrum -------------------------------------------------------------------

@pytest.mark.parametrize("n,bw", [(20_000, 2000.0), (40_000, 500.0),
                                  (15_000, 2000.0)])
@pytest.mark.parametrize("dtype", ["complex64", "complex128"])
def test_spectrum_matches_jax(n, bw, dtype):
    x = _rand_c(np.random.default_rng(n), n).astype(dtype)
    tdt = getattr(torch, dtype)
    port = SpectrumAnalyser(n, bw, 204_640_000.0, dtype=tdt, device="cpu")
    ref = JaxSpectrum(n, bw, 204_640_000.0, dtype=getattr(jnp, dtype))
    assert (port.decimation, port.n_spectrum, port.nfft) == \
        (ref.decimation, ref.n_spectrum, ref.nfft)
    np.testing.assert_array_equal(port.frequency_khz, ref.frequency_khz)
    np.testing.assert_array_equal(port._perm.numpy(), ref._perm)
    np.testing.assert_array_equal(port._twiddle.numpy(), ref._twiddle)
    got = SpectrumAnalyser.to_db(port(torch.from_numpy(x))).numpy()
    want = np.asarray(JaxSpectrum.to_db(ref(jnp.asarray(x))))
    atol = 1e-9 if dtype == "complex128" else 2e-3
    np.testing.assert_allclose(got, want, rtol=0, atol=atol)
