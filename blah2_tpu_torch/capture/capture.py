"""Capture orchestrator: source factory, record toggle, capture thread.

Parity with reference `src/capture/Capture.{h,cpp}`:
  - ``factory_source`` dispatches on config ``capture.device.type`` ∈
    {RspDuo, Usrp, HackRF, Kraken} (`Capture.cpp:11,68-155`), plus the
    TPU-build-only Synthetic source;
  - a 1 Hz status thread polls the API ``GET /capture`` and toggles IQ
    recording on state change (`Capture.cpp:32-54`);
  - replay mode short-circuits the device (`Capture.cpp:56-64`,
    `set_replay` `Capture.cpp:157-162`).
"""

from __future__ import annotations

import json
import threading
import time
import urllib.request
from typing import Optional

from blah2_tpu_torch.capture.drivers import make_hardware_source
from blah2_tpu_torch.capture.replay import FileReplaySource
from blah2_tpu_torch.capture.source import Source
from blah2_tpu_torch.capture.synthetic import SyntheticSource, TargetSpec

HARDWARE_TYPES = ("RspDuo", "Usrp", "HackRF", "Kraken")


def factory_source(device_type: str, fs: float, fc: float,
                   device_config: Optional[dict] = None,
                   path: Optional[str] = None) -> Source:
    device_config = device_config or {}
    if device_type in HARDWARE_TYPES:
        return make_hardware_source(device_type, fs, fc, device_config, path)
    if device_type == "Synthetic":
        targets = [
            TargetSpec(t.get("delay", 0), t.get("doppler", 0.0),
                       t.get("amplitude", 0.1))
            for t in device_config.get("targets", [])
        ]
        return SyntheticSource(
            fs, fc, targets,
            clutter_amplitude=device_config.get("clutterAmplitude", 0.0),
            noise_amplitude=device_config.get("noiseAmplitude", 1e-3),
            seed=device_config.get("seed", 0),
            path=path,
        )
    raise ValueError(f"Unknown capture device type: {device_type}")


class Capture:
    def __init__(self, device_type: str, fs: float, fc: float,
                 path: Optional[str] = None):
        self.device_type = device_type
        self.fs = fs
        self.fc = fc
        self.path = path
        self.replay_enabled = False
        self.replay_loop = True
        self.replay_file = ""
        self.device: Optional[Source] = None
        self._status_thread: Optional[threading.Thread] = None
        self._stop = threading.Event()

    def set_replay(self, loop: bool, file: str) -> None:
        self.replay_enabled = True
        self.replay_loop = loop
        self.replay_file = file

    def _poll_capture_status(self, api_url: str) -> None:
        """1 Hz poll of GET /capture; toggles the record file on change."""
        previous = False
        while not self._stop.is_set():
            try:
                with urllib.request.urlopen(f"{api_url}/capture", timeout=2) as r:
                    state = json.loads(r.read().decode() or "false")
            except Exception:
                state = previous
            if state != previous and self.device is not None:
                if state:
                    name = self.device.open_record_file()
                    if name:
                        print(f"[capture] recording to {name}", flush=True)
                else:
                    self.device.close_record_file()
                    print("[capture] recording stopped", flush=True)
                previous = state
            self._stop.wait(1.0)

    def process(self, buffer1, buffer2, device_config: Optional[dict] = None,
                api_ip: Optional[str] = None, api_port: Optional[int] = None) -> None:
        """Run the capture loop (call from a dedicated thread)."""
        if self.replay_enabled:
            self.device = FileReplaySource(
                self.fs, self.fc, self.replay_file, self.replay_loop,
                path=self.path, type_name=self.device_type,
            )
        else:
            self.device = factory_source(
                self.device_type, self.fs, self.fc, device_config, self.path
            )

        if api_ip and api_port:
            host = "127.0.0.1" if api_ip == "0.0.0.0" else api_ip
            self._status_thread = threading.Thread(
                target=self._poll_capture_status,
                args=(f"http://{host}:{api_port}",),
                daemon=True,
            )
            self._status_thread.start()

        self.device.start()
        try:
            self.device.process(buffer1, buffer2)
        finally:
            self.device.close_record_file()

    def stop(self) -> None:
        self._stop.set()
        if self.device is not None:
            self.device.kill()
