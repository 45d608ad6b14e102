"""SDR capture drivers: RspDuo, Usrp, HackRF, Kraken.

Host-side feeder equivalents of the reference's vendor drivers
(`src/capture/{rspduo,usrp,hackrf,kraken}`), with full configuration,
validation, and **streaming** parity. Each driver:

  * carries the reference's device parameters, derived settings, and
    validation rules (value sets, ranges, gain tables);
  * binds the vendor runtime via the ctypes bindings in
    :mod:`blah2_tpu_torch.capture.vendor` (sdrplay_api / UHD C API / libhackrf /
    librtlsdr) and streams ADC blocks into the IQ ring buffers from the
    vendor callback threads. The library handle is injectable
    (``lib=`` / ``vendor.register_fake_library``) so CI drives the full
    callback→ring→pipeline path with a fake runtime and no hardware.

TPU-first divergences from the reference (documented, intentional):
  * callbacks push vectorized NumPy blocks into the drop-oldest ring —
    not per-sample deque pushes under a mutex (`RspDuo.cpp:511-520`,
    `HackRf.cpp:115-125`); the rings' drop counters take over the
    overflow/desync accounting;
  * recordings use the universal int16-quad format of
    :meth:`Source.record` for every device so any recording replays
    everywhere (the reference writes per-device formats:
    `Usrp.cpp:96-104` float32 pairs, `RspDuo.cpp:523-535` short quads).
    Float-valued sources scale to ADC counts first
    (``Source.record_scale``); devices whose channels stream from
    independent vendor threads (HackRF, Kraken) record through the
    paired per-channel buffer of :meth:`Source.record_channel`;
  * a failed vendor call raises (``SdrplayError``/``UhdError``/…) instead
    of ``exit(1)`` (`RspDuo.cpp:118-126`) so the capture orchestrator can
    fall back or retry.
"""

from __future__ import annotations

import ctypes as C
import threading
import time
from collections import deque
from typing import List, Optional, Sequence

import numpy as np

from blah2_tpu_torch.capture.source import Source
from blah2_tpu_torch.capture.vendor import VendorLibraryUnavailable

# Back-compat alias: the round-1 API named the no-vendor-runtime error
# DriverUnavailable.
DriverUnavailable = VendorLibraryUnavailable


class RspDuoSource(Source):
    """SDRplay RSPduo dual-tuner coherent capture (`src/capture/rspduo/`).

    Derived settings and validation mirror `RspDuo.cpp:53-79,364-448`:
    sample rate selects decimation / IF bandwidth / IF mode from fixed
    tables; AGC, gain-reduction and LNA parameters are range-checked.
    Streaming follows the dual-callback protocol of
    `RspDuo.cpp:106-148,450-552`: the tuner-A callback stashes its block,
    the tuner-B callback completes the pair and pushes both channels.
    """

    #: fs → decimation (`RspDuo.cpp:53-60`); the RSPduo master clock runs
    #: at 2 MHz in dual-tuner mode and lower rates decimate.
    DECIMATION = {2_000_000: 1, 1_000_000: 2, 500_000: 4,
                  250_000: 8, 125_000: 16, 62_500: 32}
    #: fs → IF bandwidth in kHz (`RspDuo.cpp:61-68`).
    IF_BANDWIDTH_KHZ = {2_000_000: 1536, 1_000_000: 600, 500_000: 300,
                        250_000: 200, 125_000: 200, 62_500: 200}
    #: fs → IF mode in kHz (`RspDuo.cpp:69-76`): always the 1.62 MHz IF.
    IF_MODE_KHZ = 1620

    MAX_FREQUENCY = 2_000_000_000.0
    MIN_AGC_SET_POINT = -72
    GAIN_REDUCTION_RANGE = (20, 59)
    MAX_LNA_STATE = 9
    VALID_AGC_BANDWIDTH = (0, 5, 50, 100)

    def __init__(self, fs: float, fc: float,
                 agc_set_point: int = -60, bandwidth_number: int = 0,
                 gain_reduction: Sequence[int] = (40, 40),
                 lna_state: int = 4, dab_notch: bool = False,
                 rf_notch: bool = False, usb_bulk: bool = False,
                 path: Optional[str] = None, lib=None):
        super().__init__("RspDuo", fs, fc, path)
        self.agc_set_point = int(agc_set_point)
        self.bandwidth_number = int(bandwidth_number)
        # The reference accepts a scalar gainReduction applied to both
        # tuners (`config/radar4.yml` uses 59; `config/config.yml` a
        # 2-list) — broadcast scalars for config-file parity.
        if isinstance(gain_reduction, (int, float)):
            gain_reduction = (gain_reduction, gain_reduction)
        self.gain_reduction = [int(g) for g in gain_reduction]
        self.lna_state = int(lna_state)
        self.dab_notch = bool(dab_notch)
        self.rf_notch = bool(rf_notch)
        self.usb_bulk = bool(usb_bulk)
        self._lib = lib

        fs_i = int(fs)
        if fs_i not in self.DECIMATION:
            raise ValueError(
                f"RspDuo fs must be one of {sorted(self.DECIMATION)} Hz, "
                f"got {fs_i}")
        self.n_decimation = self.DECIMATION[fs_i]
        self.if_bandwidth_khz = self.IF_BANDWIDTH_KHZ[fs_i]
        self.if_mode_khz = self.IF_MODE_KHZ
        self.validate()

        self._api = None
        self._device = None
        self._cbfns = None
        self._pending_a: deque = deque()
        self._buffer1 = None
        self._buffer2 = None
        #: dropped B-blocks that arrived with no pending A block (desync).
        self.n_desync = 0
        #: most recent total system gain reported by the event callback.
        self.current_gain_db: Optional[float] = None
        self.overload = False

    def validate(self) -> None:
        """Parameter checks of `RspDuo.cpp:364-448`."""
        if self.n_decimation not in (1, 2, 4, 8, 16, 32):
            raise ValueError("Decimation must be in {1, 2, 4, 8, 16, 32}")
        if not (1 <= self.fc <= self.MAX_FREQUENCY):
            raise ValueError(
                f"Frequency must be between 1 and {self.MAX_FREQUENCY}")
        if self.bandwidth_number not in self.VALID_AGC_BANDWIDTH:
            raise ValueError(
                f"AGC bandwidth must be in {self.VALID_AGC_BANDWIDTH}")
        if not (self.MIN_AGC_SET_POINT <= self.agc_set_point <= 0):
            raise ValueError(
                f"AGC set point must be between {self.MIN_AGC_SET_POINT} "
                "and 0")
        lo, hi = self.GAIN_REDUCTION_RANGE
        for g in self.gain_reduction:
            if not (lo <= g <= hi):
                raise ValueError(
                    f"Gain reduction must be between {lo} and {hi}")
        if not (1 <= self.lna_state <= self.MAX_LNA_STATE):
            raise ValueError(
                f"LNA state must be between 1 and {self.MAX_LNA_STATE}")

    # -- protocol (RspDuo.cpp:93-148) ------------------------------------------
    def start(self) -> None:
        """Open the API, select the RSPduo in dual-tuner mode, write the
        device parameter tree (`RspDuo.cpp:93-99,243-448`)."""
        from blah2_tpu_torch.capture.vendor import sdrplay as S

        super().start()
        self._api = S.SdrplayApi(lib=self._lib)
        self._api.open()
        try:
            self._device = self._api.select_rspduo_dual_tuner()
        except Exception:
            self._api.close()
            self._api = None
            raise
        try:
            params = self._api.get_device_params(self._device.dev)
            self._configure_params(params)
        except Exception:
            # Release the selected device on a failed parameter write so
            # the API is not left locked to it (a retry would otherwise
            # find the RSPduo permanently claimed).
            self._api.release(self._device)
            self._api.close()
            self._api = None
            self._device = None
            raise

    def _configure_params(self, params) -> None:
        """Write the device parameter tree (`RspDuo.cpp:243-448`)."""
        from blah2_tpu_torch.capture.vendor import sdrplay as S

        dev = params.devParams.contents
        dev.mode = S.BULK if self.usb_bulk else S.ISOCH

        cha = params.rxChannelA.contents
        cha.tunerParams.rfFreq.rfHz = self.fc
        agc_map = {0: S.AGC_DISABLE, 5: S.AGC_5HZ, 50: S.AGC_50HZ,
                   100: S.AGC_100HZ}
        cha.ctrlParams.agc.enable = agc_map[self.bandwidth_number]
        if cha.ctrlParams.agc.enable != S.AGC_DISABLE:
            cha.ctrlParams.agc.setPoint_dBfs = min(0, self.agc_set_point)
        cha.ctrlParams.decimation.enable = 1
        cha.ctrlParams.decimation.decimationFactor = self.n_decimation
        cha.tunerParams.ifType = S.IF_1620
        cha.tunerParams.bwType = self.if_bandwidth_khz
        cha.rspDuoTunerParams.rfNotchEnable = int(self.rf_notch)
        cha.rspDuoTunerParams.rfDabNotchEnable = int(self.dab_notch)

        chb = params.rxChannelB.contents
        cha.tunerParams.gain.gRdB = self.gain_reduction[0]
        cha.tunerParams.gain.LNAstate = self.lna_state
        chb.tunerParams.gain.gRdB = self.gain_reduction[1]
        chb.tunerParams.gain.LNAstate = self.lna_state
        self._params = params

    def _stream_a(self, xi, xq, params, num_samples, reset, ctx) -> None:
        """Tuner-A callback: stash the block (`RspDuo.cpp:450-491`)."""
        n = int(num_samples)
        if n <= 0:
            return
        i = np.ctypeslib.as_array(xi, (n,)).copy()
        q = np.ctypeslib.as_array(xq, (n,)).copy()
        self._pending_a.append((i, q))

    def _stream_b(self, xi, xq, params, num_samples, reset, ctx) -> None:
        """Tuner-B callback: pair with the stashed A block, push both
        channels and record (`RspDuo.cpp:493-552`)."""
        n = int(num_samples)
        if n <= 0:
            return
        if not self._pending_a:
            self.n_desync += 1
            return
        ai, aq = self._pending_a.popleft()
        bi = np.ctypeslib.as_array(xi, (n,)).copy()
        bq = np.ctypeslib.as_array(xq, (n,)).copy()
        m = min(len(ai), n)
        ch1 = ai[:m].astype(np.float32) + 1j * aq[:m].astype(np.float32)
        ch2 = bi[:m].astype(np.float32) + 1j * bq[:m].astype(np.float32)
        if self._buffer1 is not None:
            self._buffer1.push(ch1.astype(np.complex64))
            self._buffer2.push(ch2.astype(np.complex64))
        self.record(ch1, ch2)

    def _event(self, event_id, tuner, params, ctx) -> None:
        """Event callback (`RspDuo.cpp:554-588`): track gain changes,
        acknowledge power overloads, notice device removal."""
        from blah2_tpu_torch.capture.vendor import sdrplay as S

        if event_id == S.EventGainChange:
            self.current_gain_db = float(params.contents.gainParams.currGain)
        elif event_id == S.EventPowerOverloadChange:
            p = params.contents.powerOverloadParams
            self.overload = (
                p.powerOverloadChangeType == S.Overload_Detected)
            self._api.update(self._device.dev, tuner,
                             S.Update_Ctrl_OverloadMsgAck)
        elif event_id == S.EventDeviceRemoved:
            self.stopped = True

    def process(self, buffer1, buffer2) -> None:
        """Init the stream and run the control loop
        (`RspDuo.cpp:106-148`): callbacks fill the rings from the vendor
        threads; this thread re-applies gains post-init and idles."""
        from blah2_tpu_torch.capture.vendor import sdrplay as S

        if self._api is None:
            self.start()
        self._buffer1, self._buffer2 = buffer1, buffer2
        self._cbfns = S.CallbackFnsT(
            S.StreamCallback(self._stream_a),
            S.StreamCallback(self._stream_b),
            S.EventCallback(self._event))
        inited = False
        try:
            self._api.init(self._device.dev, self._cbfns)
            inited = True
            # Gains are re-applied after init (`RspDuo.cpp:112-134`).
            self._params.rxChannelA.contents.tunerParams.gain.gRdB = \
                self.gain_reduction[0]
            self._params.rxChannelB.contents.tunerParams.gain.gRdB = \
                self.gain_reduction[1]
            self._api.update(self._device.dev, S.Tuner_A, S.Update_Tuner_Gr)
            self._api.update(self._device.dev, S.Tuner_B, S.Update_Tuner_Gr)
            while not self.stopped:
                time.sleep(0.01)
        finally:
            # A failed Init must still release + close, or the API stays
            # locked to the selected device; Uninit only after a
            # successful Init.
            if inited:
                self._api.uninit(self._device.dev)
            self._api.release(self._device)
            self._api.close()


class UsrpSource(Source):
    """Ettus USRP 2-channel streamer (`src/capture/usrp/Usrp.cpp:30-105`):
    subdev/antenna/gain configuration, fc32 host format, timed continuous
    stream start (+50 ms) so both channels are sample-aligned. Bound via
    the UHD C API (the C++ `multi_usrp` ABI is not ctypes-callable)."""

    STREAM_START_DELAY_S = 0.05
    HOST_FORMAT = "fc32"
    WIRE_FORMAT = "sc16"
    #: fc32 samples are normalized to [-1, 1]; map full scale onto the
    #: int16-quad record format (the reference records raw float32 pairs,
    #: `Usrp.cpp:96-104` — the universal-format divergence needs this
    #: scale or the unscaled cast truncates everything to {-1, 0, 1}).
    record_scale = 32767.0

    def __init__(self, fs: float, fc: float, address: str = "localhost",
                 subdev: str = "A:A A:B",
                 antenna: Sequence[str] = ("RX2", "RX2"),
                 gain: Sequence[float] = (20.0, 20.0),
                 path: Optional[str] = None, lib=None):
        super().__init__("Usrp", fs, fc, path)
        self.address = address
        self.subdev = subdev
        self.antenna = list(antenna)
        self.gain = [float(g) for g in gain]
        self._lib = lib
        if len(self.antenna) != 2:
            raise ValueError("Usrp needs exactly 2 antenna entries")
        if len(self.gain) != 2:
            raise ValueError("Usrp needs exactly 2 gain entries")

    def process(self, buffer1, buffer2) -> None:
        """Configure and run the recv loop (`Usrp.cpp:30-105`).

        Every handle is created under the cleanup scope: a failed setup
        call (bad subdev, unreachable address, rejected rate) releases
        whatever was already claimed, so a retry against the same device
        does not hit a leaked, still-claimed handle."""
        from blah2_tpu_torch.capture.vendor import uhd as U

        api = U.UhdApi(lib=self._lib)
        lib = api.lib

        usrp = C.c_void_p()
        spec = C.c_void_p()
        streamer = C.c_void_p()
        meta = C.c_void_p()
        streaming = False
        try:
            api.check(lib.uhd_usrp_make(
                C.byref(usrp), f"addr={self.address}".encode()), "make usrp")

            api.check(lib.uhd_subdev_spec_make(
                C.byref(spec), self.subdev.encode()), "make subdev spec")
            api.check(lib.uhd_usrp_set_rx_subdev_spec(usrp, spec, 0),
                      "set subdev spec")
            for ch in (0, 1):
                api.check(lib.uhd_usrp_set_rx_antenna(
                    usrp, self.antenna[ch].encode(), ch), "set antenna")
            api.check(lib.uhd_usrp_set_rx_rate(usrp, self.fs, 0),
                      "set rate ch0")
            api.check(lib.uhd_usrp_set_rx_rate(usrp, self.fs, 1),
                      "set rate ch1")
            for ch in (0, 1):
                req = U.TuneRequestT(
                    target_freq=self.fc,
                    rf_freq_policy=U.TUNE_REQUEST_POLICY_AUTO,
                    dsp_freq_policy=U.TUNE_REQUEST_POLICY_AUTO)
                res = U.TuneResultT()
                api.check(lib.uhd_usrp_set_rx_freq(
                    usrp, C.byref(req), ch, C.byref(res)), "set freq")
                api.check(lib.uhd_usrp_set_rx_gain(
                    usrp, self.gain[ch], ch, b""), "set gain")

            api.check(lib.uhd_rx_streamer_make(C.byref(streamer)),
                      "make rx streamer")
            channels = (C.c_size_t * 2)(0, 1)
            args = U.StreamArgsT(
                cpu_format=self.HOST_FORMAT.encode(),
                otw_format=self.WIRE_FORMAT.encode(),
                args=b"", channel_list=channels, n_channels=2)
            api.check(lib.uhd_usrp_get_rx_stream(
                usrp, C.byref(args), streamer), "get rx stream")

            max_samps = C.c_size_t(0)
            api.check(lib.uhd_rx_streamer_max_num_samps(
                streamer, C.byref(max_samps)), "max_num_samps")
            samps = int(max_samps.value) or 4096

            # Timed start +50 ms aligns both channels (`Usrp.cpp:71-73`).
            full = C.c_int64(0)
            frac = C.c_double(0.0)
            api.check(lib.uhd_usrp_get_time_now(
                usrp, 0, C.byref(full), C.byref(frac)), "get_time_now")
            t = full.value + frac.value + self.STREAM_START_DELAY_S
            cmd = U.StreamCmdT(
                stream_mode=U.STREAM_MODE_START_CONTINUOUS,
                num_samps=0, stream_now=False,
                time_spec_full_secs=int(t), time_spec_frac_secs=t - int(t))
            api.check(lib.uhd_rx_streamer_issue_stream_cmd(
                streamer, C.byref(cmd)), "issue stream cmd")
            streaming = True

            api.check(lib.uhd_rx_metadata_make(C.byref(meta)),
                      "make metadata")

            buf1 = np.empty(samps, dtype=np.complex64)
            buf2 = np.empty(samps, dtype=np.complex64)
            ptrs = (C.c_void_p * 2)(
                buf1.ctypes.data_as(C.c_void_p).value,
                buf2.ctypes.data_as(C.c_void_p).value)
            received = C.c_size_t(0)
            while not self.stopped:
                api.check(lib.uhd_rx_streamer_recv(
                    streamer, ptrs, samps, C.byref(meta), 3.0, False,
                    C.byref(received)), "recv")
                ec = C.c_int(0)
                lib.uhd_rx_metadata_error_code(meta, C.byref(ec))
                if ec.value != U.RX_METADATA_ERROR_NONE:
                    print(f"[Usrp] recv error code {ec.value}", flush=True)
                n = int(received.value)
                if n <= 0:
                    continue
                buffer1.push(buf1[:n].copy())
                buffer2.push(buf2[:n].copy())
                self.record(buf1[:n], buf2[:n])
        finally:
            if streaming:
                stop = U.StreamCmdT(
                    stream_mode=U.STREAM_MODE_STOP_CONTINUOUS,
                    stream_now=True)
                lib.uhd_rx_streamer_issue_stream_cmd(streamer, C.byref(stop))
            for free_fn, handle in (("uhd_rx_metadata_free", meta),
                                    ("uhd_rx_streamer_free", streamer),
                                    ("uhd_subdev_spec_free", spec)):
                fn = getattr(lib, free_fn, None)
                if fn is not None and handle:
                    fn(C.byref(handle))
            if usrp:
                lib.uhd_usrp_free(C.byref(usrp))


class HackRfSource(Source):
    """2× HackRF with shared clock + hardware sync trigger
    (`src/capture/hackrf/HackRf.cpp`, `README.md`): the surveillance unit
    is configured first with hw-sync + CLKOUT; both stream 8-bit IQ via
    `rx_callback`."""

    VALID_LNA_GAIN = tuple(range(0, 41, 8))   # {0,8,...,40} dB
    VALID_VGA_GAIN = tuple(range(0, 63, 2))   # {0,2,...,62} dB

    def __init__(self, fs: float, fc: float,
                 serial: Sequence[str] = ("", ""),
                 gain_lna: Sequence[int] = (32, 32),
                 gain_vga: Sequence[int] = (30, 30),
                 amp_enable: Sequence[bool] = (False, False),
                 path: Optional[str] = None, lib=None):
        super().__init__("HackRF", fs, fc, path)
        self.serial = list(serial)
        self.gain_lna = [int(g) for g in gain_lna]
        self.gain_vga = [int(g) for g in gain_vga]
        self.amp_enable = [bool(a) for a in amp_enable]
        self._lib = lib
        for g in self.gain_lna:
            if g not in self.VALID_LNA_GAIN:
                raise ValueError(
                    f"Invalid LNA gain {g}; valid: {self.VALID_LNA_GAIN}")
        for g in self.gain_vga:
            if g not in self.VALID_VGA_GAIN:
                raise ValueError(
                    f"Invalid VGA gain {g}; valid: {self.VALID_VGA_GAIN}")
        if len(self.serial) != 2:
            raise ValueError("HackRF needs exactly 2 serial numbers")
        self._api = None
        self._dev = [C.c_void_p(), C.c_void_p()]
        self._callbacks = []

    def _setup_device(self, idx: int) -> None:
        """Open + configure one unit (`HackRf.cpp:63-96`). The
        surveillance unit (idx 1) additionally enables hw-sync + CLKOUT."""
        api, lib = self._api, self._api.lib
        api.check(lib.hackrf_open_by_serial(
            self.serial[idx].encode(), C.byref(self._dev[idx])),
            "Failed to open device.")
        d = self._dev[idx]
        api.check(lib.hackrf_set_freq(d, int(self.fc)),
                  "Failed to set frequency.")
        api.check(lib.hackrf_set_sample_rate(d, float(self.fs)),
                  "Failed to set sample rate.")
        api.check(lib.hackrf_set_amp_enable(
            d, 1 if self.amp_enable[idx] else 0), "Failed to set AMP status.")
        api.check(lib.hackrf_set_lna_gain(d, self.gain_lna[idx]),
                  "Failed to set LNA gain.")
        api.check(lib.hackrf_set_vga_gain(d, self.gain_vga[idx]),
                  "Failed to set VGA gain.")
        if idx == 1:
            api.check(lib.hackrf_set_hw_sync_mode(d, 1),
                      "Failed to enable hardware synchronising.")
            api.check(lib.hackrf_set_clkout_enable(d, 1),
                      "Failed to set CLKOUT on surveillance device")

    def start(self) -> None:
        from blah2_tpu_torch.capture.vendor import hackrf as H

        super().start()
        self._api = H.HackrfApi(lib=self._lib)
        lib = self._api.lib
        self._api.check(lib.hackrf_init(), "Failed to initialise HackRF")
        try:
            dl = lib.hackrf_device_list()
            count = dl.contents.devicecount if dl else 0
            if count < 2:
                raise H.HackrfError("Failed to find 2 HackRF devices.")
            # Surveillance first: its CLKOUT clocks the reference unit
            # (`HackRf.cpp:64-96`).
            self._setup_device(1)
            self._setup_device(0)
        except Exception:
            # A partial setup (e.g. unit 1 opened, unit 0 missing) must
            # close whatever opened and exit the library, or the claimed
            # unit blocks every retry.
            for d in self._dev:
                if d:
                    lib.hackrf_close(d)
            self._dev = [C.c_void_p(), C.c_void_p()]
            lib.hackrf_exit()
            raise

    def _make_callback(self, ring, chan: int):
        """Per-channel rx callback: int8 interleaved IQ → complex block
        (`HackRf.cpp:107-133`, vectorized). Uses valid_length (the filled
        size) where the reference reads buffer_length — intentional.
        ``chan`` routes the block to the paired recorder (each unit
        streams from its own vendor thread)."""
        from blah2_tpu_torch.capture.vendor import hackrf as H

        def cb(transfer_ptr):
            tr = transfer_ptr.contents
            n = int(tr.valid_length)
            if n < 2:
                return 0
            raw = np.ctypeslib.as_array(tr.buffer, (n,))
            block = (raw[0::2].astype(np.float32)
                     + 1j * raw[1::2].astype(np.float32)).astype(np.complex64)
            ring.push(block)
            self.record_channel(chan, block)
            return 0

        fn = H.RxCallback(cb)
        self._callbacks.append(fn)  # keep alive for the C side
        return fn

    def process(self, buffer1, buffer2) -> None:
        """Start both RX streams, then idle until stopped
        (`HackRf.cpp:107-113`)."""
        if self._api is None:
            self.start()
        lib = self._api.lib
        self._api.check(lib.hackrf_start_rx(
            self._dev[1], self._make_callback(buffer2, 1), None),
            "Failed to start RX streaming.")
        self._api.check(lib.hackrf_start_rx(
            self._dev[0], self._make_callback(buffer1, 0), None),
            "Failed to start RX streaming.")
        try:
            while not self.stopped:
                time.sleep(0.01)
        finally:
            lib.hackrf_stop_rx(self._dev[0])
            lib.hackrf_stop_rx(self._dev[1])
            lib.hackrf_close(self._dev[0])
            lib.hackrf_close(self._dev[1])
            lib.hackrf_exit()


class KrakenSource(Source):
    """KrakenSDR 5-tuner rtlsdr array, 2 channels used
    (`src/capture/kraken/Kraken.cpp`): per-channel dithering and AGC are
    disabled; requested gains round UP to the tuner's valid gain list;
    two `rtlsdr_read_async` reader threads feed the rings."""

    READ_ASYNC_BUF_LEN = 16 * 16384  # `Kraken.cpp:89-90`

    def __init__(self, fs: float, fc: float,
                 gain: Sequence[float] = (15.0, 15.0),
                 path: Optional[str] = None, lib=None):
        super().__init__("Kraken", fs, fc, path)
        self.requested_gain = [float(g) for g in gain]
        self.gain: List[int] = []
        self._lib = lib
        self._api = None
        self._devs = [C.c_void_p(), C.c_void_p()]
        self._callbacks = []

    @staticmethod
    def round_gains(requested_db: Sequence[float],
                    valid_tenth_db: Sequence[int]) -> List[int]:
        """Round each requested gain (dB) up to the next valid tuner gain
        (tenth-dB units), clamping to the maximum (`Kraken.cpp:35-48`)."""
        valid = sorted(valid_tenth_db)
        out = []
        for g in requested_db:
            tenth = int(g * 10)
            nxt = next((v for v in valid if v >= tenth), valid[-1])
            out.append(nxt)
        return out

    def start(self) -> None:
        """Enumerate valid gains (device 0), then open + configure both
        channels (`Kraken.cpp:20-74`)."""
        from blah2_tpu_torch.capture.vendor import rtlsdr as R

        super().start()
        self._api = R.RtlsdrApi(lib=self._lib)
        lib = self._api.lib

        probe = C.c_void_p()
        self._api.check(lib.rtlsdr_open(C.byref(probe), 0),
                        "Failed to open device for available gains.")
        try:
            valid = self._api.tuner_gains(probe)
        except Exception:
            # Unwinding from a gain-enumeration failure: close the probe
            # without check() so a close error cannot replace the root
            # cause.
            lib.rtlsdr_close(probe)
            raise
        self._api.check(lib.rtlsdr_close(probe),
                        "Failed to close device for available gains.")
        self.gain = self.round_gains(self.requested_gain, valid)

        try:
            for i in range(2):
                self._api.check(lib.rtlsdr_open(C.byref(self._devs[i]), i),
                                "Failed to open device.")
                d = self._devs[i]
                self._api.check(lib.rtlsdr_set_center_freq(d, int(self.fc)),
                                "Failed to set center frequency.")
                self._api.check(lib.rtlsdr_set_sample_rate(d, int(self.fs)),
                                "Failed to set sample rate.")
                self._api.check(lib.rtlsdr_set_dithering(d, 0),
                                "Failed to disable dithering.")
                self._api.check(lib.rtlsdr_set_tuner_gain_mode(d, 1),
                                "Failed to disable AGC.")
                self._api.check(lib.rtlsdr_set_tuner_gain(d, self.gain[i]),
                                "Failed to set gain.")
                self._api.check(lib.rtlsdr_reset_buffer(d),
                                "Failed to reset buffer.")
        except Exception:
            # Close any channel already opened so a config failure on
            # channel 1 does not leave channel 0 claimed.
            for d in self._devs:
                if d:
                    lib.rtlsdr_close(d)
            self._devs = [C.c_void_p(), C.c_void_p()]
            raise

    def _make_callback(self, ring, chan: int):
        """uint8 interleaved IQ → complex block. The reference casts the
        raw bytes to int8 (`Kraken.cpp:101-108`), keeping rtlsdr's
        offset-127 encoding as a DC offset; mirrored here. ``chan``
        routes the block to the paired recorder (each tuner reads from
        its own async thread)."""
        from blah2_tpu_torch.capture.vendor import rtlsdr as R

        def cb(buf, length, ctx):
            n = int(length)
            if n < 2:
                return
            raw = np.ctypeslib.as_array(buf, (n,)).astype(np.int8)
            block = (raw[0::2].astype(np.float32)
                     + 1j * raw[1::2].astype(np.float32)).astype(np.complex64)
            ring.push(block)
            self.record_channel(chan, block)

        fn = R.ReadAsyncCallback(cb)
        self._callbacks.append(fn)
        return fn

    def process(self, buffer1, buffer2) -> None:
        """Two blocking `rtlsdr_read_async` reader threads
        (`Kraken.cpp:86-99`); a watchdog cancels them on stop."""
        if self._api is None:
            self.start()
        lib = self._api.lib
        threads = []
        for chan, (dev, ring) in enumerate(((self._devs[0], buffer1),
                                            (self._devs[1], buffer2))):
            cb = self._make_callback(ring, chan)
            t = threading.Thread(
                target=lib.rtlsdr_read_async,
                args=(dev, cb, None, 0, self.READ_ASYNC_BUF_LEN),
                daemon=True)
            t.start()
            threads.append(t)
        try:
            while not self.stopped and any(t.is_alive() for t in threads):
                time.sleep(0.01)
        finally:
            for dev in self._devs:
                lib.rtlsdr_cancel_async(dev)
            for t in threads:
                t.join(timeout=2.0)
            for dev in self._devs:
                lib.rtlsdr_close(dev)


def make_hardware_source(device_type: str, fs: float, fc: float,
                         cfg: dict, path: Optional[str] = None) -> Source:
    """Config-schema-parity factory (`Capture.cpp:68-155`)."""
    if device_type == "RspDuo":
        return RspDuoSource(
            fs, fc,
            agc_set_point=cfg.get("agcSetPoint", -60),
            bandwidth_number=cfg.get("bandwidthNumber", 0),
            gain_reduction=cfg.get("gainReduction", [40, 40]),
            lna_state=cfg.get("lnaState", 4),
            dab_notch=cfg.get("dabNotch", False),
            rf_notch=cfg.get("rfNotch", False),
            usb_bulk=cfg.get("usbBulk", False),
            path=path)
    if device_type == "Usrp":
        return UsrpSource(
            fs, fc,
            address=cfg.get("address", "localhost"),
            subdev=cfg.get("subdev", "A:A A:B"),
            antenna=cfg.get("antenna", ["RX2", "RX2"]),
            gain=cfg.get("gain", [20.0, 20.0]),
            path=path)
    if device_type == "HackRF":
        return HackRfSource(
            fs, fc,
            serial=cfg.get("serial", ["", ""]),
            gain_lna=cfg.get("gain_lna", [32, 32]),
            gain_vga=cfg.get("gain_vga", [30, 30]),
            amp_enable=cfg.get("amp_enable", [False, False]),
            path=path)
    if device_type == "Kraken":
        return KrakenSource(
            fs, fc, gain=cfg.get("gain", [15.0, 15.0]), path=path)
    raise ValueError(f"Unknown hardware source type: {device_type}")
