"""Node-op tests: the XLA PLF (site-major and lane-major) vs the golden model.

The acceptance criterion mirrors the reference host's correctness check
(app/src/host_mem.cpp:403-442) — every CLV element and the scaler
increments — with the few-ULP allowance of a compiler that contracts
mul+add into FMA (conftest.assert_clv_match); scaler counts are exact.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from plf_tpu.ops import layout as L
from plf_tpu.ops.plf_xla import DOT_ALGORITHM, plf_lane_major, plf_xla
from plf_tpu.reference import plf_reference
from tests.conftest import assert_clv_match, make_random_case

BLOCK = 128  # site padding unit of the lane-major cases


def plf_padded(x1, x2, left, right, ev, wgt, states=4, categories=4,
               variant="vpu"):
    """Site-major in/out through the lane-major op with the sites padded
    to a BLOCK multiple (padding must never count a rescale)."""
    S, C = states, categories
    n = np.asarray(x1).reshape(-1, C, S).shape[0]
    x1l = L.pad_to_multiple(L.to_lane_major(np.asarray(x1), S, C), BLOCK)
    x2l = L.pad_to_multiple(L.to_lane_major(np.asarray(x2), S, C), BLOCK)
    x3l, sc = plf_lane_major(x1l, x2l, left, right, ev, n, states=S,
                             categories=C, variant=variant)
    sv = np.asarray(sc)
    assert not sv[n:].any(), "padding counted a rescale"
    return (L.from_lane_major(np.asarray(x3l), S, C, n=n), sv[:n],
            int(np.sum(sv[:n] * np.asarray(wgt))))


def _run_case(case, fn, **kw):
    x1, x2, left, right, ev, wgt = case
    return fn(x1, x2, left, right, ev, wgt, **kw)


# ---------------------------------------------------------------- layout ---

def test_lane_major_roundtrip():
    rng = np.random.default_rng(2)
    clv = rng.random((300, 4, 4), dtype=np.float32)
    lm = L.to_lane_major(clv)
    assert lm.shape == (16, 300)
    back = L.from_lane_major(lm, n=300)
    np.testing.assert_array_equal(back, clv)
    # row order: r = state*C + cat
    np.testing.assert_array_equal(lm[2 * 4 + 1], clv[:, 1, 2])


def test_lane_major_roundtrip_protein():
    rng = np.random.default_rng(3)
    clv = rng.random((130, 4, 20), dtype=np.float32)
    lm = L.to_lane_major(clv, states=20)
    assert lm.shape == (80, 130)
    np.testing.assert_array_equal(L.from_lane_major(lm, states=20, n=130), clv)


def test_padding_policy():
    assert L.sites_padding(1, 128) == 128
    assert L.sites_padding(128, 128) == 128
    assert L.sites_padding(129, 128) == 256
    x = np.ones((16, 100), np.float32)
    assert L.pad_to_multiple(x, 128).shape == (16, 128)


# ------------------------------------------------------------------- XLA ---

@pytest.mark.parametrize("n", [64, 333])
def test_xla_matches_golden_exact(n):
    rng = np.random.default_rng(5)
    case = make_random_case(rng, n)
    ref = plf_reference(*case)
    got = _run_case(case, plf_xla)
    assert_clv_match(got[0], ref[0])
    np.testing.assert_array_equal(np.asarray(got[1]), ref[1].astype(np.int32))
    assert int(got[2]) == ref[2]


def test_xla_protein_matches_golden():
    rng = np.random.default_rng(6)
    case = make_random_case(rng, 40, states=20)
    ref = plf_reference(*case, states=20)
    got = _run_case(case, plf_xla, states=20)
    assert_clv_match(got[0], ref[0])
    assert int(got[2]) == ref[2]


# ----------------------------------------------------------- lane-major ---

@pytest.mark.parametrize("n", [128, 100, 257, 1000])
def test_pallas_matches_golden_exact(n):
    """The lane-major op vs golden incl. odd site counts (padding path)."""
    rng = np.random.default_rng(11)
    case = make_random_case(rng, n)
    ref = plf_reference(*case)
    got = _run_case(case, plf_padded)
    assert_clv_match(got[0], ref[0])
    np.testing.assert_array_equal(np.asarray(got[1]),
                                  ref[1].astype(np.int32))
    assert int(got[2]) == ref[2]


def test_pallas_no_underflow_case():
    rng = np.random.default_rng(12)
    case = make_random_case(rng, 256, underflow=False)
    ref = plf_reference(*case)
    got = _run_case(case, plf_padded)
    assert_clv_match(got[0], ref[0])
    assert int(got[2]) == ref[2] == 0


def test_pallas_scaler_excludes_padding():
    """Padding sites must not contribute scaler counts even when the padded
    lanes compute all-zero x3 (|0| < 2^-32 would otherwise trigger)."""
    rng = np.random.default_rng(13)
    case = make_random_case(rng, 100, underflow=True)
    ref = plf_reference(*case)
    got = _run_case(case, plf_padded)
    assert int(got[2]) == ref[2]
    assert np.asarray(got[1]).shape == (100,)


def test_pallas_protein_matches_golden():
    rng = np.random.default_rng(14)
    case = make_random_case(rng, 200, states=20)
    ref = plf_reference(*case, states=20)
    got = _run_case(case, plf_padded, states=20)
    assert_clv_match(got[0], ref[0])
    assert int(got[2]) == ref[2]


def test_pallas_weighted_scaler():
    rng = np.random.default_rng(15)
    x1, x2, left, right, ev, _ = make_random_case(rng, 256, underflow=True)
    w = rng.integers(1, 7, size=256).astype(np.int32)
    ref = plf_reference(x1, x2, left, right, ev, w)
    got = plf_padded(x1, x2, left, right, ev, w)
    assert int(got[2]) == ref[2]


# ------------------------------------------------------- engine dispatch ---

def test_engine_backends_agree():
    from plf_tpu import PLFConfig, PLFEngine
    from plf_tpu.config import Backend
    rng = np.random.default_rng(16)
    case = make_random_case(rng, 200)
    ref = plf_reference(*case)
    for backend in (Backend.XLA, Backend.PALLAS, Backend.REFERENCE):
        eng = PLFEngine(PLFConfig(backend=backend, block_sites=BLOCK))
        out = eng.plf(*case)
        assert_clv_match(out.x3, ref[0])
        assert int(out.scaler_increment) == ref[2]
        ok, nerr, msgs = eng.verify(out, *case)
        assert ok, msgs


def test_engine_multi_instance():
    """The 9-accelerator equivalent: batched independent node pairs."""
    from plf_tpu import PLFConfig, PLFEngine
    rng = np.random.default_rng(17)
    I, n = 3, 128
    cases = [make_random_case(rng, n) for _ in range(I)]
    x1 = np.stack([c[0] for c in cases])
    x2 = np.stack([c[1] for c in cases])
    left = np.stack([c[2] for c in cases])
    right = np.stack([c[3] for c in cases])
    ev = np.stack([c[4] for c in cases])
    wgt = np.stack([c[5] for c in cases])
    eng = PLFEngine(PLFConfig(block_sites=BLOCK, instances=I))
    out = eng.plf_batch(x1, x2, left, right, ev, wgt)
    for i, c in enumerate(cases):
        ref = plf_reference(*c)
        assert_clv_match(out.x3[i], ref[0])
        assert int(out.scaler_increment[i]) == ref[2]


def test_pallas_bf16_fast_mode():
    """bf16 CLV storage: not exact, but within bf16 tolerance of golden."""
    rng = np.random.default_rng(60)
    case = make_random_case(rng, 256, underflow=False)
    x1, x2, left, right, ev, wgt = case
    ref = plf_reference(*case)
    x1l = jnp.asarray(L.to_lane_major(x1), jnp.bfloat16)
    x2l = jnp.asarray(L.to_lane_major(x2), jnp.bfloat16)
    x3l, sc = plf_lane_major(x1l, x2l, left, right, ev, 256)
    assert x3l.dtype == jnp.bfloat16
    got = np.asarray(L.from_lane_major(x3l.astype(jnp.float32), n=256))
    np.testing.assert_allclose(got, ref[0], rtol=0.05, atol=0.02)


@pytest.mark.parametrize("n", [256, 333])
def test_pallas_mxu_variant_matches_golden(n):
    """Dot form at F32_F32_F32 vs golden (ULP tolerance)."""
    rng = np.random.default_rng(63)
    case = make_random_case(rng, n)
    ref = plf_reference(*case)
    got = _run_case(case, plf_padded, variant="mxu")
    assert_clv_match(got[0], ref[0], exact=False)
    assert int(got[2]) == ref[2]


def test_pallas_mxu_protein():
    rng = np.random.default_rng(64)
    case = make_random_case(rng, 200, states=20)
    ref = plf_reference(*case, states=20)
    got = _run_case(case, plf_padded, states=20, variant="mxu")
    assert_clv_match(got[0], ref[0], exact=False)
    assert int(got[2]) == ref[2]


@pytest.mark.parametrize("variant", ["mxu_3x", "mxu_bf16"])
def test_mxu_reduced_precision_variants_run(variant):
    """Reduced-precision dot variants vs the element-wise form, at the
    class bound of each algorithm (the CPU computes either in fp32; a
    GPU rounds the operands as the algorithm says)."""
    S, C, n = 20, 4, 300
    rng = np.random.default_rng(11)
    x1 = rng.random((n, C * S), np.float32)
    x2 = rng.random((n, C * S), np.float32)
    left = rng.random((C, S, S), np.float32)
    right = rng.random((C, S, S), np.float32)
    ev = rng.random((S, S), np.float32)
    wgt = np.ones(n, np.int32)
    x3v, scv, incv = plf_xla(x1, x2, left, right, ev, wgt, states=S,
                             categories=C, variant="vpu")
    x3m, scm, incm = plf_xla(x1, x2, left, right, ev, wgt, states=S,
                             categories=C, variant=variant)
    rtol = 1e-4 if variant == "mxu_3x" else 2e-2
    np.testing.assert_allclose(np.asarray(x3m), np.asarray(x3v),
                               rtol=rtol, atol=1e-4)
    assert int(incm) == int(incv)


@pytest.mark.parametrize("variant,preset,operand,passes", [
    ("mxu", "F32_F32_F32", "f32", 1),
    ("mxu_3x", "BF16_BF16_F32_X3", "bf16", 3),
    ("mxu_bf16", "BF16_BF16_F32", "bf16", 1)])
def test_dot_algorithm_mapping(variant, preset, operand, passes):
    """Each dot variant names its algorithm, and all three dots of the
    node carry it (an fp32 dot can never fall to TF32 on a GPU)."""
    assert DOT_ALGORITHM[variant] is getattr(jax.lax.DotAlgorithmPreset,
                                             preset)
    assert "vpu" not in DOT_ALGORITHM
    S, C, n = 20, 2, 8
    f = functools.partial(plf_lane_major, states=S, categories=C,
                          variant=variant)
    x = jnp.ones((S * C, n))
    b = jnp.ones((C, S, S))
    text = jax.jit(f).lower(x, x, b, b, jnp.ones((S, S)), n).as_text()
    dots = [ln for ln in text.splitlines() if "dot_general" in ln]
    assert len(dots) == 3
    want = (f"lhs_precision_type = {operand}, rhs_precision_type = "
            f"{operand}, accumulation_type = f32")
    for ln in dots:
        assert want in ln and f"num_primitive_operations = {passes}" in ln
