"""Streaming-executor timing modes: the functional contract on the CPU.

Whether transfers overlap compute is a property of the device and is
not measured here (not measured on a GPU yet).
"""

import numpy as np
import pytest


def test_fenced_timing_mode_matches_pipelined():
    """timing_mode='fenced' must produce identical results and record
    phase timestamps whose per-phase device work is complete (the
    functional contract; phase accuracy needs a device)."""
    from plf_tpu.config import PLFConfig
    from plf_tpu.runtime.executor import StreamingExecutor

    rng = np.random.default_rng(0)
    n = 300
    call = (rng.random((n, 16), np.float32), rng.random((n, 16), np.float32),
            rng.random((4, 4, 4), np.float32), rng.random((4, 4, 4), np.float32),
            rng.random((4, 4), np.float32), None)
    cfg = PLFConfig(block_sites=128)
    outs = {}
    for mode in ("pipelined", "fenced"):
        ex = StreamingExecutor(cfg, inflight=2, timing_mode=mode)
        res = list(ex.run([call, call]))
        outs[mode] = res
        assert ex.timing.num_calls == 2
        assert ex.timing.total() >= 0
    if_, pf = outs["fenced"], outs["pipelined"]
    for (x3f, incf), (x3p, incp) in zip(if_, pf):
        np.testing.assert_array_equal(np.asarray(x3f), np.asarray(x3p))
        assert incf == incp
    # fenced mode forces serial execution
    assert StreamingExecutor(cfg, inflight=4,
                             timing_mode="fenced").inflight == 1
    with pytest.raises(ValueError):
        StreamingExecutor(cfg, timing_mode="bogus")
