"""Multi-device sharding tests on the 8-device virtual CPU mesh.

The equivalent of the reference's multi-instance site partitioning
(9 accelerators, ceil-div + last-instance padding, include.h:181-195)
and its host-side weighted scaler reduction (host_mem.cpp:385-388),
validated without a multi-GPU host via
xla_force_host_platform_device_count=8 (see conftest.py).
"""

import jax
import numpy as np
import pytest

from plf_tpu.ops import layout as L
from plf_tpu.parallel import ShardedPLF, make_mesh
from plf_tpu.reference import plf_reference
from tests.conftest import assert_clv_match, make_random_case

BLOCK = 128


@pytest.fixture(scope="module")
def mesh():
    return make_mesh()


def _sharded_run(mesh, case, n, ndev=None, states=4):
    x1, x2, left, right, ev, wgt = case
    sp = ShardedPLF(mesh=mesh, block_sites=BLOCK, states=states)
    xs1 = sp.prepare(x1, n)
    xs2 = sp.prepare(x2, n)
    ws = sp.prepare_weights(wgt, n)
    lc, rc, ec = sp.constants(left, right, ev)
    x3, sc, inc = sp(xs1, xs2, lc, rc, ec, ws, n)
    return sp, x3, sc, inc


def test_mesh_has_8_devices(mesh):
    assert mesh.shape["sites"] == 8


@pytest.mark.parametrize("n", [1024, 1000, 777])
def test_sharded_matches_golden(mesh, n):
    rng = np.random.default_rng(20)
    case = make_random_case(rng, n)
    ref = plf_reference(*case)
    sp, x3, sc, inc = _sharded_run(mesh, case, n)
    got = L.from_lane_major(np.asarray(x3), n=n)
    assert_clv_match(got, ref[0])
    np.testing.assert_array_equal(np.asarray(sc)[:n],
                                  ref[1].astype(np.int32))
    assert int(inc) == ref[2]


def test_sharded_scaler_reduction_weighted(mesh):
    n = 1000
    rng = np.random.default_rng(21)
    x1, x2, left, right, ev, _ = make_random_case(rng, n)
    w = rng.integers(1, 9, size=n).astype(np.int32)
    ref = plf_reference(x1, x2, left, right, ev, w)
    sp, x3, sc, inc = _sharded_run(mesh, (x1, x2, left, right, ev, w), n)
    assert int(inc) == ref[2]


def test_sharded_matches_single_device(mesh):
    """Sharded result must equal the single-device op bitwise (the
    computation is pointwise over sites — sharding is pure partitioning)."""
    from plf_tpu.ops.plf_xla import plf_xla
    n = 900
    rng = np.random.default_rng(22)
    case = make_random_case(rng, n)
    single = plf_xla(*case)
    sp, x3, sc, inc = _sharded_run(mesh, case, n)
    got = L.from_lane_major(np.asarray(x3), n=n)
    np.testing.assert_array_equal(got, np.asarray(single[0]))
    assert int(inc) == int(single[2])


def test_sharded_protein(mesh):
    n = 600
    rng = np.random.default_rng(23)
    case = make_random_case(rng, n, states=20)
    ref = plf_reference(*case, states=20)
    sp, x3, sc, inc = _sharded_run(mesh, case, n, states=20)
    got = L.from_lane_major(np.asarray(x3), states=20, n=n)
    assert_clv_match(got, ref[0])
    assert int(inc) == ref[2]


def test_padded_sites_policy(mesh):
    sp = ShardedPLF(mesh=mesh, block_sites=BLOCK)
    assert sp.padded_sites(1) == 8 * BLOCK
    assert sp.padded_sites(8 * BLOCK) == 8 * BLOCK
    assert sp.padded_sites(8 * BLOCK + 1) == 16 * BLOCK


def test_distributed_helpers(mesh):
    from plf_tpu.parallel import (global_site_mesh, process_summary,
                                  validate_site_workload)
    m = global_site_mesh()
    assert m.shape["sites"] == 8
    validate_site_workload(m, 10_000, 128)
    with pytest.raises(ValueError):
        validate_site_workload(m, 10_000, 100)    # bad block
    with pytest.raises(ValueError):
        validate_site_workload(m, 100, 128)       # too few sites/device
    with pytest.raises(ValueError):
        validate_site_workload(m, 10_000, 128, axis="nope")
    s = process_summary()
    assert "devices" in s


def test_initialize_distributed_single_host_noop():
    from plf_tpu.parallel import initialize_distributed
    assert initialize_distributed(num_processes=1) is False


def test_weak_scaling_shard_count_invariance():
    """Weak scaling's correctness half: with fixed per-device work (the
    single-device alignment tiled once per device), the per-site
    log-likelihood is identical for every device count."""
    from plf_tpu.config import PLFConfig
    from plf_tpu.models import PhyloModel, hky85, random_tree

    per_device, n_leaves = 512, 8
    tree = random_tree(n_leaves, seed=0)
    base = np.random.default_rng(1).integers(0, 4,
                                             size=(n_leaves, per_device))
    first, totals = None, []
    for n_dev in (1, 2, 4, 8):
        pm = PhyloModel(tree, hky85(2.0), np.tile(base, (1, n_dev)),
                        alpha=0.5, config=PLFConfig(block_sites=BLOCK))
        res = pm.log_likelihood_sharded(mesh=make_mesh(n_dev))
        sites = res.site_log_likelihood.reshape(n_dev, per_device)
        first = sites[0] if first is None else first
        np.testing.assert_array_equal(
            sites, np.broadcast_to(first, (n_dev, per_device)))
        totals.append(res.log_likelihood / n_dev)
    # the psum over shards sums fp32 partials in another order
    np.testing.assert_allclose(totals, totals[0], rtol=1e-6)
