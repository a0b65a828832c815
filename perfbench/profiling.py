"""What the benchmark reads from the card: the profiler's device trace over a
steady sub-window, and the card's power.

Frozen in spirit from ``chip_smoke.py`` at commit d0d3ca4 (``profile_call``'s
busy time as the kernels' own device time, ``sample_power``'s thread over
``nvidia-smi --query-gpu=power.draw``), reshaped for one long window: the
trace is read from the profiler's raw Kineto events (no per-operator tree
is built, which would take minutes over a granite-moe tick's ~6,200
kernels), and power is read through NVML where the GPU driver's library is
there, with ``nvidia-smi`` as the fallback.
"""
from __future__ import annotations

import bisect
import ctypes
import subprocess
import threading
import time

HOST_SPAN_PREFIX = "pb."
K5_KERNEL = "int8_matmul"  # in the name of every K5 instantiation


# ---------------------------------------------------------------------------
# Power
# ---------------------------------------------------------------------------
def smi_query(field: str, index: int = 0) -> str:
    """One ``nvidia-smi --query-gpu`` field of card ``index``, without units
    (frozen from ``chip_smoke.smi_query``)."""
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={field}", "--format=csv,noheader,nounits", "-i", str(index)],
        capture_output=True, text=True, check=True, timeout=10).stdout.strip().splitlines()[0]


class _Nvml:
    """The few NVML calls the meter needs, through ctypes."""

    def __init__(self, index: int):
        lib = ctypes.CDLL("libnvidia-ml.so.1")
        if lib.nvmlInit_v2() != 0:
            raise OSError("nvmlInit failed")
        self.lib, self.handle = lib, ctypes.c_void_p()
        if lib.nvmlDeviceGetHandleByIndex_v2(index, ctypes.byref(self.handle)) != 0:
            raise OSError("nvmlDeviceGetHandleByIndex failed")

    def power_w(self) -> float:
        mw = ctypes.c_uint()
        if self.lib.nvmlDeviceGetPowerUsage(self.handle, ctypes.byref(mw)) != 0:
            raise OSError("nvmlDeviceGetPowerUsage failed")
        return mw.value / 1e3

    def energy_j(self) -> float | None:
        mj = ctypes.c_ulonglong()
        if self.lib.nvmlDeviceGetTotalEnergyConsumption(self.handle, ctypes.byref(mj)) != 0:
            return None
        return mj.value / 1e3

    def close(self) -> None:
        self.lib.nvmlShutdown()


class PowerMeter:
    """``power.draw`` sampled from a thread every ``period`` seconds between
    ``start`` and ``stop``, and the card's energy counter read at both ends
    where NVML gives one.  ``energy_j`` is the counter's difference, else
    the samples integrated by the trapezoid rule over the window."""

    def __init__(self, index: int = 0, period: float = 0.1):
        self.period = period
        try:
            self._nvml = _Nvml(index)
            self._read = self._nvml.power_w
        except OSError:
            self._nvml = None
            self._read = lambda: float(smi_query("power.draw", index))
        self.samples: list[tuple[float, float]] = []
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self._e0 = self._e1 = None
        self.t0 = self.t1 = 0.0

    def _run(self) -> None:
        while not self._stop.is_set():
            self.samples.append((time.perf_counter(), self._read()))
            self._stop.wait(self.period)

    def start(self) -> None:
        self.t0 = time.perf_counter()
        self._e0 = self._nvml.energy_j() if self._nvml else None
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self.t1 = time.perf_counter()
        self._e1 = self._nvml.energy_j() if self._nvml else None
        self._stop.set()
        self._thread.join(timeout=30)
        if self._nvml:
            self._nvml.close()

    @property
    def counted(self) -> bool:
        """Whether the energy is the card's counter (else integrated samples)."""
        return self._e0 is not None and self._e1 is not None and self._e1 > self._e0

    @property
    def mean_w(self) -> float | None:
        return sum(w for _, w in self.samples) / len(self.samples) if self.samples else None

    @property
    def energy_j(self) -> float | None:
        if self.counted:
            return self._e1 - self._e0
        if len(self.samples) < 2:
            return None
        pts = [(self.t0, self.samples[0][1]), *self.samples, (self.t1, self.samples[-1][1])]
        return sum((t1 - t0) * (w0 + w1) / 2 for (t0, w0), (t1, w1) in zip(pts, pts[1:]))


# ---------------------------------------------------------------------------
# The device trace
# ---------------------------------------------------------------------------
def _raw_events(prof) -> list:
    results = getattr(getattr(prof, "profiler", None), "kineto_results", None)
    if results is None:
        raise RuntimeError("the profiler kept no Kineto results")
    return results.events()


def _union(intervals: list[tuple[int, int]]) -> list[tuple[int, int]]:
    merged: list[list[int]] = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return [(a, b) for a, b in merged]


def summarize_trace(prof, window_s: float) -> dict:
    """From one profiled sub-window: ``busy_s`` (the union of the device's
    operation intervals), the idle share over ``window_s``, the device
    operations that took most time, the device's idle gaps by the host
    span (``pb.*``) open at their midpoint, and K5's events and device
    seconds."""
    from torch.autograd import DeviceType

    device, spans = [], []
    for e in _raw_events(prof):
        name = e.name()
        if e.device_type() == DeviceType.CUDA and not name.startswith(HOST_SPAN_PREFIX):
            # (the host spans come back on the device's timeline too, as GPU
            # user annotations: they are not device work)
            device.append((name, e.start_ns(), e.start_ns() + e.duration_ns()))
        elif e.device_type() != DeviceType.CUDA and name.startswith(HOST_SPAN_PREFIX):
            spans.append((name[len(HOST_SPAN_PREFIX):], e.start_ns(), e.start_ns() + e.duration_ns()))
    merged = _union([(a, b) for _, a, b in device])
    busy_s = sum(b - a for a, b in merged) / 1e9
    by_name: dict[str, float] = {}
    k5_s, k5_events = 0.0, 0
    for name, a, b in device:
        by_name[name] = by_name.get(name, 0.0) + (b - a) / 1e9
        if K5_KERNEL in name:
            k5_s += (b - a) / 1e9
            k5_events += 1
    gaps: dict[str, float] = {}
    spans.sort(key=lambda s: s[1])
    starts = [s[1] for s in spans]
    for (_, end), (start, _) in zip(merged, merged[1:]):
        mid = (end + start) / 2
        # the innermost (latest-starting) host span open at the gap's
        # midpoint; the loop's spans nest at most two deep
        i = bisect.bisect_right(starts, mid) - 1
        label = "between spans"
        for j in range(i, max(i - 3, -1), -1):
            if spans[j][2] >= mid:
                label = spans[j][0]
                break
        gaps[label] = gaps.get(label, 0.0) + (start - end) / 1e9
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    return {"busy_s": busy_s, "window_s": window_s, "device_ops": [[n, s] for n, s in top],
            "idle_gaps": [[n, s] for n, s in sorted(gaps.items(), key=lambda kv: -kv[1])[:10]],
            "k5_device_s": k5_s, "k5_events": k5_events, "device_events": len(device)}
