"""Fuzzing harness: random configs x {vpu, mxu} x {site-major, padded
lane-major} vs the golden model.

The reference's correctness bar is exact float equality against the CPU
plf() on every element of every run (app/src/host_mem.cpp:403-442).  This
harness sweeps random (states, categories, site-count, block, underflow
density) configurations and holds every form of the XLA node op to the
corresponding bar:

  vpu (element-wise, golden order): <= 4 ULP (the compiler contracts FMAs)
  mxu (F32_F32_F32 dots)          : <= 16 ULP (dot reassociation)

and scaler flags and weighted scaler increments exact for every form.
"""

import numpy as np
import pytest

import jax.numpy as jnp

from plf_tpu.ops import layout as L
from plf_tpu.ops.plf_xla import plf_lane_major, plf_xla
from plf_tpu.reference import plf_reference

N_CASES = 12


def _ulp_diff(a, b):
    ai = np.asarray(a, np.float32).view(np.int32).astype(np.int64)
    bi = np.asarray(b, np.float32).view(np.int32).astype(np.int64)
    return np.abs(ai - bi)


def _random_case(rng):
    S = int(rng.choice([4, 4, 4, 20]))   # weight DNA; one-in-four protein
    C = int(rng.choice([2, 4]))
    n = int(rng.integers(3, 400))
    block = int(rng.choice([64, 128]))
    x1 = rng.random((n, C * S), dtype=np.float32)
    x2 = rng.random((n, C * S), dtype=np.float32)
    # force some underflow sites (the reference's 1e-12 pattern,
    # host_mem.cpp:190-196)
    under = rng.random(n) < 0.3
    x1[under] *= np.float32(1e-12)
    x2[under] *= np.float32(1e-12)
    left = rng.random((C, S, S), dtype=np.float32)
    right = rng.random((C, S, S), dtype=np.float32)
    ev = rng.random((S, S), dtype=np.float32)
    wgt = rng.integers(1, 5, size=n).astype(np.int32)
    return S, C, n, block, x1, x2, left, right, ev, wgt


@pytest.mark.parametrize("seed", range(N_CASES))
def test_fuzz_backends_vs_golden(seed):
    rng = np.random.default_rng(1000 + seed)
    S, C, n, block, x1, x2, left, right, ev, wgt = _random_case(rng)
    g3, gsv, ginc = plf_reference(x1, x2, left, right, ev, wgt,
                                  states=S, categories=C)

    for variant, ulp in (("vpu", 4), ("mxu", 16)):
        # lane-major with the sites padded to a block multiple
        x1l = L.pad_to_multiple(L.to_lane_major(x1, S, C), block)
        x2l = L.pad_to_multiple(L.to_lane_major(x2, S, C), block)
        x3l, sc = plf_lane_major(x1l, x2l, left, right, ev, n, states=S,
                                 categories=C, variant=variant)
        sc = np.asarray(sc)
        assert not sc[n:].any()
        assert sc[:n].astype(np.uint8).tolist() == gsv.tolist()
        assert int(np.sum(sc[:n] * wgt)) == ginc
        m3 = L.from_lane_major(np.asarray(x3l), S, C, n=n)
        assert _ulp_diff(m3, g3).max() <= ulp, (variant, S, C, n)

    # XLA stages
    x3, xsv, xinc = plf_xla(jnp.asarray(x1), jnp.asarray(x2),
                            jnp.asarray(left), jnp.asarray(right),
                            jnp.asarray(ev), jnp.asarray(wgt),
                            states=S, categories=C)
    assert np.asarray(xsv).astype(np.uint8).tolist() == gsv.tolist()
    assert int(xinc) == ginc
    assert _ulp_diff(np.asarray(x3).reshape(n, C, S), g3).max() <= 4
