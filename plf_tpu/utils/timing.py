"""Timing, bandwidth and throughput reporting.

Re-design of the reference's measurement layer
(app/src/timing.h:9-194): a phase timer that brackets host->HBM transfer,
device compute, and device->host readback separately (the reference's
hm/msm/mh split, timing.h:36-63), figure-of-merit converters (MB/s and
MA/s = million alignment-sites/second, timing.h:101-106), formatted report
tables (timing.h:107-151) and per-call CSV archiving (timing.h:153-194).

Phases are measured with ``jax.block_until_ready`` fences, the JAX
equivalent of enqueueing timestamps inside the reference's xrt::queues
(host_mem.cpp:294-318).
"""

from __future__ import annotations

import csv
import dataclasses
import time
from typing import Dict, List, Optional

import numpy as np

__all__ = ["Timer", "TimingData", "bandwidth_MBs", "bandwidth_As",
           "format_timing_table", "write_csv"]


class Timer:
    """Monotonic millisecond timer (timing.h:9-33 analogue)."""

    def __init__(self):
        self.reset()

    def reset(self):
        self._t0 = time.perf_counter()

    def elapsed_ms(self) -> float:
        return (time.perf_counter() - self._t0) * 1e3


@dataclasses.dataclass
class TimingData:
    """Per-call phase timestamps: begin -> t1 -> t2 -> end (ms).

    Phases (timing.h:36-63):
      hm  = t1 - begin   host -> device memory
      msm = t2 - t1      device compute (mem -> kernel -> mem)
      mh  = end - t2     device memory -> host
    """

    begin: List[float] = dataclasses.field(default_factory=list)
    t1: List[float] = dataclasses.field(default_factory=list)
    t2: List[float] = dataclasses.field(default_factory=list)
    end: List[float] = dataclasses.field(default_factory=list)

    @property
    def num_calls(self) -> int:
        return len(self.begin)

    def _phase(self, a, b, call=None):
        if call is not None:
            return b[call] - a[call]
        return float(np.sum(np.asarray(b) - np.asarray(a)))

    def hm(self, call=None) -> float:
        return self._phase(self.begin, self.t1, call)

    def msm(self, call=None) -> float:
        return self._phase(self.t1, self.t2, call)

    def mh(self, call=None) -> float:
        return self._phase(self.t2, self.end, call)

    def total(self, call=None) -> float:
        return self._phase(self.begin, self.end, call)

    def min_msm(self) -> float:
        return float(np.min(np.asarray(self.t2) - np.asarray(self.t1)))

    def max_msm(self) -> float:
        return float(np.max(np.asarray(self.t2) - np.asarray(self.t1)))

    def record(self, begin, t1, t2, end):
        self.begin.append(begin)
        self.t1.append(t1)
        self.t2.append(t2)
        self.end.append(end)


def bandwidth_MBs(time_ms: float, data_bytes: float) -> float:
    """MB/s (timing.h:101-103)."""
    if time_ms <= 0:
        return float("inf")
    return (data_bytes / 1e6) / (time_ms / 1e3)


def bandwidth_As(time_ms: float, alignments: float) -> float:
    """Alignment sites per second (timing.h:104-106)."""
    if time_ms <= 0:
        return float("inf")
    return alignments / (time_ms / 1e3)


def format_timing_table(d: TimingData, data_bytes: float,
                        total_alignments: int,
                        reference_ms: Optional[float] = None) -> str:
    """Reference-style report (timing.h:107-151)."""
    lines = []
    bar = "=" * 101
    lines.append(bar)
    lines.append(f"| {'Timing region':38} | {'time (ms)':10} | "
                 f"{'bandwidth (MB/s)':16} | {'bandwidth (MA/s)':24} |")
    lines.append(bar)

    def row(label, ms, byt=data_bytes, aln=total_alignments):
        lines.append(
            f"| {label:38} | {ms:10.3f} | "
            f"{bandwidth_MBs(ms, byt):16.1f} | "
            f"{bandwidth_As(ms, aln) * 1e-6:24.3f} |")

    row("Host to device memory:", d.hm())
    row("Device compute (HBM->SM->HBM):", d.msm())
    if d.num_calls > 1:
        row("  - slowest call:", d.max_msm(), data_bytes / d.num_calls,
            total_alignments / d.num_calls)
        row("  - fastest call:", d.min_msm(), data_bytes / d.num_calls,
            total_alignments / d.num_calls)
    row("Device memory to host:", d.mh())
    row("Total execution time:", d.total())
    lines.append(bar)
    if reference_ms is not None:
        lines.append(f"| {'Reference (CPU golden):':38} | "
                     f"{reference_ms:10.3f} |")
        if d.msm() > 0:
            lines.append(f"| {'Speed up (excluding transfers):':38} | "
                         f"{reference_ms / d.msm():10.2f} |")
        if d.total() > 0:
            lines.append(f"| {'Speed up (including transfers):':38} | "
                         f"{reference_ms / d.total():10.2f} |")
        lines.append(bar)
    return "\n".join(lines)


def write_csv(path: str, data: Dict[str, TimingData]):
    """Per-call per-phase CSV (timing.h:153-194 analogue).

    One column group per named TimingData (the reference writes one per
    instance); rows are calls.
    """
    names = list(data)
    n_calls = max(d.num_calls for d in data.values())
    with open(path, "w", newline="") as f:
        wr = csv.writer(f)
        header = []
        for nm in names:
            header += [f"hm_{nm}", f"msm_{nm}", f"mh_{nm}"]
        wr.writerow(header)
        for call in range(n_calls):
            rowv = []
            for nm in names:
                d = data[nm]
                if call < d.num_calls:
                    rowv += [d.hm(call), d.msm(call), d.mh(call)]
                else:
                    rowv += ["", "", ""]
            wr.writerow(rowv)
