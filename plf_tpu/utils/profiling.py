"""Profiling / tracing utilities.

Maps the reference's four tracing mechanisms (SURVEY.md §5: xrt user
ranges, in-queue phase timestamps, AIE PLIO cycle profiling, xrt.ini
device traces) onto the JAX stack:

* :func:`trace` — context manager around ``jax.profiler`` producing a
  Perfetto/XPlane trace directory (the device_trace analogue),
* :class:`PhaseProfiler` — named user ranges with wall-ms accounting
  (the ``xrt::profile::user_range`` analogue, host_mem.cpp:273-282),
* :func:`throughput_report` — sites/s + GB/s + roofline fraction
  reporter (the MA/s tables, timing.h:101-151), against the published
  peaks of :data:`PEAKS`.
"""

from __future__ import annotations

import contextlib
import time
from typing import Dict, Optional

__all__ = ["trace", "PhaseProfiler", "throughput_report", "PEAKS",
           "device_peaks", "PLF_BYTES_PER_SITE"]

PLF_BYTES_PER_SITE = 196      # 2 CLV reads + 1 write + scaler (BASELINE.md)

#: Published peaks by ``jax.Device.device_kind``: NVIDIA H100 data sheet,
#: SXM part, dense rates, at the full 700 W power limit.  A card set to a
#: lower limit reaches less; report the limit beside every share.
_H100 = {"hbm_gbps": 3350.0, "fp32_tflops": 67.0, "tf32_tflops": 495.0,
         "bf16_tflops": 989.0}
PEAKS = {
    "NVIDIA H100 80GB HBM3": _H100,
    "NVIDIA H100": _H100,
}


def device_peaks(device_kind: Optional[str] = None) -> Dict[str, float]:
    """Published peaks of a device kind (default: the first device's).
    A kind that is not in :data:`PEAKS` is an error, not a default."""
    if device_kind is None:
        import jax
        device_kind = jax.devices()[0].device_kind
    try:
        return PEAKS[device_kind]
    except KeyError:
        raise ValueError(
            f"no published peaks for device kind {device_kind!r}; "
            f"known: {sorted(PEAKS)}") from None


@contextlib.contextmanager
def trace(logdir: str):
    """Capture a device trace: ``with trace('/tmp/trace'): run()``.

    View with TensorBoard or Perfetto.  No-op fallback if the profiler
    backend is unavailable (some virtual device setups).
    """
    import jax
    try:
        jax.profiler.start_trace(logdir)
        started = True
    except Exception:
        started = False
    try:
        yield
    finally:
        if started:
            try:
                jax.profiler.stop_trace()
            except Exception:
                pass


class PhaseProfiler:
    """Named wall-clock ranges: ``with prof.range("plf"): ...``."""

    def __init__(self):
        self.totals: Dict[str, float] = {}
        self.counts: Dict[str, int] = {}

    @contextlib.contextmanager
    def range(self, name: str):
        import jax
        t0 = time.perf_counter()
        try:
            with jax.profiler.TraceAnnotation(name):
                yield
        finally:
            dt = time.perf_counter() - t0
            self.totals[name] = self.totals.get(name, 0.0) + dt
            self.counts[name] = self.counts.get(name, 0) + 1

    def report(self) -> str:
        lines = [f"{'range':24} {'calls':>6} {'total ms':>10} {'avg ms':>10}"]
        for name, tot in sorted(self.totals.items()):
            c = self.counts[name]
            lines.append(f"{name:24} {c:6d} {tot*1e3:10.2f} "
                         f"{tot*1e3/c:10.2f}")
        return "\n".join(lines)


def throughput_report(sites: int, seconds: float,
                      bytes_per_site: int = PLF_BYTES_PER_SITE,
                      device_kind: Optional[str] = None,
                      label: str = "PLF") -> str:
    """One-line sites/s + bandwidth + roofline summary against the
    published HBM rate of ``device_kind`` (default: the first device)."""
    hbm_gbps = device_peaks(device_kind)["hbm_gbps"]
    sps = sites / seconds
    gbs = sps * bytes_per_site / 1e9
    roof = sps / (hbm_gbps * 1e9 / bytes_per_site)
    return (f"{label}: {sps/1e9:.3f} Gsites/s | {gbs:.0f} GB/s effective | "
            f"{100*roof:.1f}% of {hbm_gbps:.0f} GB/s HBM roofline")
