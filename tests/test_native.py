"""Native runtime library tests: bit-exact vs the NumPy golden model."""

import numpy as np
import pytest

from plf_tpu.runtime import native
from plf_tpu.ops import layout as L
from plf_tpu.reference import plf_reference
from tests.conftest import make_random_case

pytestmark = pytest.mark.skipif(
    not native.native_available(),
    reason="native toolchain unavailable (libplf_native.so not built)")


def test_native_golden_bitexact_vs_numpy():
    rng = np.random.default_rng(30)
    case = make_random_case(rng, 1000)
    ref = plf_reference(*case)
    x3, sv, inc = native.plf_golden_native(*case)
    np.testing.assert_array_equal(x3, ref[0])
    np.testing.assert_array_equal(sv, ref[1])
    assert inc == ref[2]


def test_native_golden_multithreaded_exact():
    rng = np.random.default_rng(31)
    case = make_random_case(rng, 50_000)
    x3a, sva, inca = native.plf_golden_native(*case, threads=1)
    x3b, svb, incb = native.plf_golden_native(*case, threads=8)
    np.testing.assert_array_equal(x3a, x3b)
    assert inca == incb
    ref = plf_reference(*case)
    np.testing.assert_array_equal(x3b, ref[0])
    assert incb == ref[2]


def test_native_golden_protein():
    rng = np.random.default_rng(32)
    case = make_random_case(rng, 500, states=20)
    ref = plf_reference(*case, states=20)
    x3, sv, inc = native.plf_golden_native(*case, states=20)
    np.testing.assert_array_equal(x3, ref[0])
    assert inc == ref[2]


def test_native_lane_layout_roundtrip():
    rng = np.random.default_rng(33)
    clv = rng.random((777, 16), dtype=np.float32)
    lm = native.to_lane_major_native(clv)
    np.testing.assert_array_equal(lm, L.to_lane_major(clv))
    back = native.from_lane_major_native(lm, n=777)
    np.testing.assert_array_equal(back.reshape(777, 16), clv)


def test_native_instance_packing_roundtrip():
    rng = np.random.default_rng(34)
    ev = rng.random((4, 4), dtype=np.float32)
    branch = rng.random((4, 4, 4), dtype=np.float32)
    clv = rng.random((100, 4, 4), dtype=np.float32)
    for combined in (True, False):
        buf = native.pack_instance_native(ev, branch, clv,
                                          combined=combined)
        # COMBINED header = EV+branch (5*16 elems, include.h:207-209);
        # SEPARATE right header = branch only (4*16, include.h:210-221).
        header = (5 if combined else 4) * 16
        assert buf.size == header + 100 * 16
        ev2, br2, clv2 = native.unpack_instance_native(
            buf, 100, combined=combined)
        if combined:
            np.testing.assert_array_equal(ev2, ev)
        np.testing.assert_array_equal(br2, branch)
        np.testing.assert_array_equal(clv2, clv)


def test_native_transpose_branch():
    rng = np.random.default_rng(35)
    b = rng.random((4, 4, 4), dtype=np.float32)
    t = native.transpose_branch_native(b)
    np.testing.assert_array_equal(t, np.transpose(b, (0, 2, 1)))
    # Round trip through the fixture convention: untransposing the
    # transposed block recovers the original (io/fixtures semantics).
    t2 = native.transpose_branch_native(t)
    np.testing.assert_array_equal(t2, b)


def test_streaming_executor_pipeline():
    """Executor yields correct results for a stream of distinct calls."""
    from plf_tpu.config import PLFConfig
    from plf_tpu.runtime import StreamingExecutor
    rng = np.random.default_rng(36)
    cases = [make_random_case(rng, 200) for _ in range(5)]
    ex = StreamingExecutor(PLFConfig(block_sites=128, interpret=True),
                           inflight=2)
    results = list(ex.run(iter(cases)))
    assert len(results) == 5
    for (x3, inc), case in zip(results, cases):
        ref = plf_reference(*case)
        np.testing.assert_allclose(np.asarray(x3), ref[0], rtol=5e-7,
                                   atol=1e-37)
        assert inc == ref[2]
    assert ex.timing.num_calls == 5
    assert ex.timing.total() > 0


def test_run_chunked_giant_sites():
    """Chunked streaming matches a single whole call (the 1e9-sites
    streaming capability, scaled down)."""
    from plf_tpu.config import PLFConfig
    from plf_tpu.runtime import StreamingExecutor
    rng = np.random.default_rng(70)
    case = make_random_case(rng, 1000)
    x1, x2, left, right, ev, wgt = case
    ref = plf_reference(*case)
    ex = StreamingExecutor(PLFConfig(block_sites=128, interpret=True),
                           inflight=2)
    x3, inc = ex.run_chunked(x1, x2, left, right, ev, wgt,
                             chunk_sites=256)
    np.testing.assert_allclose(x3, ref[0], rtol=5e-7, atol=1e-37)
    assert inc == ref[2]
    assert ex.timing.num_calls == 4  # 1000 sites / 256-chunks


def test_checkpoint_roundtrip(tmp_path):
    from plf_tpu.utils.checkpoint import (checkpoint_exists,
                                          load_checkpoint, save_checkpoint)
    p = str(tmp_path / "state.npz")
    assert not checkpoint_exists(p)
    rng = np.random.default_rng(71)
    arrays = {"clv_root": rng.random((16, 128), np.float32).astype(np.float32),
              "scaler": np.int32(42)}
    save_checkpoint(p, arrays, meta={"n_sites": 100, "tree": "((a,b),c);"})
    assert checkpoint_exists(p)
    back, meta = load_checkpoint(p)
    np.testing.assert_array_equal(back["clv_root"], arrays["clv_root"])
    assert int(back["scaler"]) == 42
    assert meta["n_sites"] == 100


def test_tree_golden_oracle_matches_kernels():
    """Native whole-tree golden oracle == the tree kernels' per-site
    likelihood + rescale counts (the host-recompute verification of
    host_mem.cpp:403-442 at tree level)."""
    from plf_tpu.config import PLFConfig
    from plf_tpu.models import PhyloModel, hky85, random_tree
    from plf_tpu.runtime.native import (plf_tree_golden_native,
                                        tree_golden_for_model,
                                        native_available)

    n_leaves, n = 14, 300
    tree = random_tree(n_leaves, seed=2)
    rng = np.random.default_rng(2)
    tips = rng.integers(0, 4, size=(n_leaves, n))
    tips[3, ::6] = 4      # IUPAC R
    tips[5, 1::7] = -1    # gap
    pm = PhyloModel(tree, hky85(2.0), tips, alpha=0.5,
                    config=PLFConfig(block_sites=128, interpret=True))
    lik, sc = tree_golden_for_model(pm)
    res = pm.log_likelihood(method="per-node")
    np.testing.assert_array_equal(sc[:n], np.asarray(res.scaler_sites))
    np.testing.assert_allclose(np.log(lik.astype(np.float64)),
                               res.site_log_likelihood, rtol=1e-6)
    res_f = pm.log_likelihood(method="fused")
    np.testing.assert_array_equal(sc[:n],
                                  np.asarray(res_f.scaler_sites))


def test_tree_golden_native_equals_numpy_fallback():
    from plf_tpu.models import PhyloModel, hky85, random_tree
    from plf_tpu.config import PLFConfig
    from plf_tpu.runtime import native as nat

    if not nat.native_available():
        pytest.skip("no native toolchain")
    n_leaves, n = 10, 200
    tree = random_tree(n_leaves, seed=4)
    tips = np.random.default_rng(4).integers(0, 4, size=(n_leaves, n))
    pm = PhyloModel(tree, hky85(2.0), tips, alpha=0.5,
                    config=PLFConfig(block_sites=128))
    lik_c, sc_c = nat.tree_golden_for_model(pm)
    # force the numpy fallback path
    lib, nat._lib = nat._lib, None
    orig = nat.load_native
    try:
        nat.load_native = lambda: None
        lik_np, sc_np = nat.tree_golden_for_model(pm)
    finally:
        nat.load_native = orig
        nat._lib = lib
    np.testing.assert_array_equal(sc_c, sc_np)
    np.testing.assert_array_equal(lik_c, lik_np)
