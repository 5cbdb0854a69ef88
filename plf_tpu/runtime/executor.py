"""Streaming PLF executor: overlapped host->device transfer and compute.

Re-design of the reference's async queue pipeline
(app/src/host_mem.cpp:249-394): there, per instance, two xrt::queues
chain bo.write(left) || bo.write(right) -> {mm2sleft, mm2sright, s2mm}
-> bo.read(out), so call k+1's PCIe writes overlap call k's compute.

Here the same overlap falls out of JAX's async dispatch: ``device_put``
returns immediately and the runtime pipelines transfers with compute, so
the executor only needs to (a) keep >=2 calls in flight, (b) fence with
phase timestamps for the hm/msm/mh split (utils/timing.py), and (c) not
block until results are consumed.  This path exists for workloads whose
CLVs originate on the host each call (the reference's benchmark shape);
production tree traversal keeps CLVs device-resident and never touches
this.

Two timing modes (``timing_mode=``):

* ``"pipelined"`` (default) — maximum overlap; the per-phase
  timestamps are ENQUEUE times (async dispatch returns before the
  copy/kernel lands), so only ``total`` and the wall clock are
  trustworthy — phase attribution lands in whatever phase finally
  fences (the reference's "roundtrip" mode has the same property,
  host_mem.cpp:349-378).
* ``"fenced"`` — each phase is fenced before its timestamp (the
  device work of that phase completes first), so hm/msm/mh are
  accurate per-phase times at the cost of serialization — the
  analogue of the reference's in-stream queue-enqueued timestamps
  ("intermediate" mode, host_mem.cpp:294-318, timing.h:36-63).
"""

from __future__ import annotations

import functools
from typing import Iterable, Iterator, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..config import PLFConfig
from ..ops import layout as L
from ..ops.plf_xla import plf_lane_major
from ..utils.timing import Timer, TimingData

__all__ = ["StreamingExecutor"]


class StreamingExecutor:
    """Pipelines a stream of PLF calls with host<->device overlap.

    Example::

        ex = StreamingExecutor(PLFConfig())
        for x3, scaler_inc in ex.run(calls):   # calls yields input tuples
            ...
    """

    def __init__(self, config: Optional[PLFConfig] = None,
                 inflight: int = 2, device=None,
                 timing_mode: str = "pipelined"):
        if timing_mode not in ("pipelined", "fenced"):
            raise ValueError(f"unknown timing_mode {timing_mode!r}")
        self.config = config or PLFConfig()
        # fenced mode serializes phases by construction; >1 in flight
        # would only blur the attribution it exists to provide
        self.inflight = 1 if timing_mode == "fenced" else max(1, inflight)
        self.timing_mode = timing_mode
        self.device = device or jax.devices()[0]
        self.timing = TimingData()
        cfg = self.config
        self._kernel = functools.partial(
            plf_lane_major, states=cfg.states, categories=cfg.categories,
            variant=cfg.resolved_kernel_variant)

    def _upload(self, call):
        """Async host->device: lane-major conversion + device_put."""
        cfg = self.config
        S, C = cfg.states, cfg.categories
        x1, x2, left, right, ev, wgt = call
        n = np.asarray(x1).reshape(-1, C * S).shape[0]
        put = functools.partial(jax.device_put, device=self.device)
        x1l = put(L.pad_to_multiple(
            L.to_lane_major(np.asarray(x1, np.float32), S, C),
            cfg.block_sites))
        x2l = put(L.pad_to_multiple(
            L.to_lane_major(np.asarray(x2, np.float32), S, C),
            cfg.block_sites))
        lc = put(np.asarray(left, np.float32).reshape(C, S, S))
        rc = put(np.asarray(right, np.float32).reshape(C, S, S))
        ec = put(np.asarray(ev, np.float32).reshape(S, S))
        w = put(np.asarray(
            wgt if wgt is not None else np.ones(n), np.int32))
        return n, (x1l, x2l, lc, rc, ec, w)

    def run(self, calls: Iterable[Tuple]) -> Iterator[Tuple]:
        """Stream calls through the device; yields (x3, scaler_increment).

        ``calls`` yields (x1, x2, left, right, ev, wgt) in site-major host
        layout.  Results come back site-major.  Keeps ``inflight`` calls
        queued so transfer of call k+1 overlaps compute of call k (the
        reference's intermediate-results mode, host_mem.cpp:287-325).
        """
        cfg = self.config
        S, C = cfg.states, cfg.categories
        t = Timer()
        pending = []
        it = iter(calls)

        fenced = self.timing_mode == "fenced"

        def fence(*arrs):
            jax.block_until_ready(arrs)

        def launch(call):
            begin = t.elapsed_ms()
            n, dev_args = self._upload(call)
            if fenced:
                fence(*dev_args)
            t1 = t.elapsed_ms()
            x1l, x2l, lc, rc, ec, w = dev_args
            x3, sc = self._kernel(x1l, x2l, lc, rc, ec, jnp.int32(n))
            inc = jnp.sum(sc[:n] * w)
            if fenced:
                fence(x3, inc)
            t2 = t.elapsed_ms()
            return (n, x3, inc, begin, t1, t2)

        def drain(slot):
            n, x3, inc, begin, t1, t2 = slot
            x3h = np.asarray(x3)           # fences device completion
            inch = int(np.asarray(inc))
            end = t.elapsed_ms()
            self.timing.record(begin, t1, t2, end)
            return L.from_lane_major(x3h, S, C, n=n), inch

        exhausted = False

        def try_launch():
            nonlocal exhausted
            if exhausted:
                return
            try:
                pending.append(launch(next(it)))
            except StopIteration:
                exhausted = True

        while not exhausted and len(pending) < self.inflight:
            try_launch()
        while pending:
            slot = pending.pop(0)
            try_launch()   # refill before the blocking drain: overlap
            yield drain(slot)

    def run_repeated(self, call, plf_calls: int) -> Tuple:
        """The reference benchmark shape: the same node pair, K times
        (host_mem.cpp plf_calls loop).  Returns the last result."""
        out = None
        for out in self.run(call for _ in range(plf_calls)):
            pass
        return out

    def run_chunked(self, x1, x2, left, right, ev, wgt=None,
                    chunk_sites: int = 1 << 22):
        """One giant PLF split into device-sized site chunks.

        The reference sweeps ALIGNMENT_SITES up to 1e9 (Makefile:16) —
        beyond device memory — by streaming windows from host RAM.  This
        is the device version: the site axis is chunked, chunks stream
        through the pipelined executor (transfer of chunk k+1 overlaps
        compute of chunk k), results concatenate on host.

        Returns ``(x3, scaler_increment)`` — the (n, C, S) site-major
        parent CLV and the summed weighted rescale count.
        """
        cfg = self.config
        S, C = cfg.states, cfg.categories
        x1 = np.asarray(x1, np.float32).reshape(-1, C * S)
        x2 = np.asarray(x2, np.float32).reshape(-1, C * S)
        n = x1.shape[0]
        if wgt is None:
            wgt = np.ones(n, np.int32)
        wgt = np.asarray(wgt, np.int32)
        chunk_sites = max(cfg.block_sites,
                          chunk_sites // cfg.block_sites * cfg.block_sites)

        def calls():
            for lo in range(0, n, chunk_sites):
                hi = min(lo + chunk_sites, n)
                yield (x1[lo:hi], x2[lo:hi], left, right, ev, wgt[lo:hi])

        outs = []
        inc_total = 0
        for x3, inc in self.run(calls()):
            outs.append(np.asarray(x3).reshape(-1, C * S))
            inc_total += int(inc)
        return np.concatenate(outs, axis=0).reshape(n, C, S), inc_total
