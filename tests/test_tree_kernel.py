"""Whole-tree paths: the Triton kernel (in the Pallas interpreter) and the
XLA traversal against each other, a NumPy golden chain and the float64
brute force; schedule reordering and register lowering; path choice."""

import jax
import numpy as np
import pytest

from plf_tpu.config import Backend, PLFConfig
from plf_tpu.models import PhyloModel, hky85, jc69, random_gtr, random_tree
from plf_tpu.ops import tree_triton
from plf_tpu.ops.schedule import (compile_register_schedule,
                                  reorder_schedule, schedule_depth)
from plf_tpu.reference import plf_reference


def _phylo(n_leaves=6, n_sites=300, states=4, seed=9, alpha=0.6, **cfg):
    tree = random_tree(n_leaves, seed=seed)
    model = hky85(2.0, [0.3, 0.2, 0.3, 0.2]) if states == 4 else \
        random_gtr(states, seed)
    rng = np.random.default_rng(seed)
    tips = rng.integers(0, states, size=(n_leaves, n_sites))
    tips[1, :7] = -1
    cfg = PLFConfig(states=states, block_sites=128, interpret=True, **cfg)
    return PhyloModel(tree, model, tips, alpha=alpha, config=cfg)


def _caterpillar(n_leaves, n_sites=256, seed=5, **cfg):
    from plf_tpu.models import parse_newick
    nwk = "A0:0.1"
    for i in range(1, n_leaves):
        nwk = f"({nwk},A{i}:0.1):0.1"
    tree = parse_newick(nwk + ";")
    tips = np.random.default_rng(seed).integers(0, 4,
                                                size=(n_leaves, n_sites))
    return PhyloModel(tree, jc69(), tips,
                      config=PLFConfig(block_sites=128, interpret=True,
                                       **cfg))


def _assert_paths_agree(a, b):
    """Kernel vs traversal: per-site ll to fp32 rounding, scalers equal."""
    np.testing.assert_array_equal(a.scaler_sites, b.scaler_sites)
    np.testing.assert_allclose(a.site_log_likelihood,
                               b.site_log_likelihood, rtol=5e-6, atol=1e-7)


# ------------------------------------------------------------- schedules ---

def test_reorder_schedule_preserves_postorder():
    tree = random_tree(12, seed=3)
    sched = tree.schedule()
    re = reorder_schedule(sched, tree.n_leaves)
    assert len(re) == len(sched)
    # dependencies: children computed before parents
    done = set(range(tree.n_leaves))
    for (p, l, r, _, _, e) in re:
        assert l in done and r in done
        done.add(p)
    # edge indices are a permutation of the original positions
    assert sorted(x[5] for x in re) == list(range(len(sched)))


def test_reorder_reduces_depth_on_caterpillar():
    from plf_tpu.models import parse_newick
    nwk = "A0:0.1"
    for i in range(1, 20):
        nwk = f"({nwk},A{i}:0.1):0.1"
    tree = parse_newick(nwk + ";")
    sched = reorder_schedule(tree.schedule(), tree.n_leaves)
    # caterpillar evaluated tall-child-first needs only O(1) live CLVs
    assert schedule_depth(sched, tree.n_leaves) <= 3


def test_register_schedule_compilation():
    tree = random_tree(50, seed=4)
    sched = reorder_schedule(tree.schedule(), tree.n_leaves)
    arrs, n_slots, root_slot = compile_register_schedule(
        sched, tree.n_leaves)
    assert n_slots <= schedule_depth(sched, tree.n_leaves)
    assert 0 <= root_slot < n_slots
    lsrc, lflag, rsrc, rflag, oslot, eidx = arrs
    assert sorted(eidx) == list(range(49))
    # flags: leaf operands index leaves, slot operands index the arena
    assert (lsrc[lflag == 0] < tree.n_leaves).all()
    assert (lsrc[lflag == 1] < n_slots).all()


# ------------------------------------------------ kernel vs references ---

def test_fused_matches_per_node_traversal():
    pm = _phylo()
    fused = pm.log_likelihood(method="fused")
    pernode = pm.log_likelihood(method="per-node")
    assert (fused.method, pernode.method) == ("fused", "per-node")
    assert fused.scaler_total == pernode.scaler_total
    _assert_paths_agree(fused, pernode)


def test_fused_matches_bruteforce():
    pm = _phylo(n_leaves=7, seed=12)
    out = pm.log_likelihood(method="fused")
    bf = pm.log_likelihood_bruteforce()
    assert abs(out.log_likelihood - bf) / abs(bf) < 1e-5


def test_fused_deep_tree_scalers():
    """A 16-leaf caterpillar forces 2^32 rescales in the kernel."""
    pm = _caterpillar(16)
    fused = pm.log_likelihood(method="fused")
    pernode = pm.log_likelihood(method="per-node")
    assert fused.scaler_total == pernode.scaler_total > 0
    _assert_paths_agree(fused, pernode)
    bf = pm.log_likelihood_bruteforce()
    assert abs(fused.log_likelihood - bf) / abs(bf) < 1e-5


def test_fused_exact_vs_numpy_golden_chain():
    """The kernel against a NumPy chain in the golden op order (tip table
    -> per-node golden -> sequential root reduction), to fp32 rounding."""
    pm = _phylo(n_leaves=4, n_sites=200, seed=21, alpha=None)
    fused = pm.log_likelihood(method="fused")

    S = C = 4
    w = pm.model.w
    wg = np.concatenate([w, w.sum(axis=1, keepdims=True)], axis=1)
    codes = np.where((pm.tip_states >= 0) & (pm.tip_states < S),
                     pm.tip_states, S)
    clvs = {}
    n = pm.n_sites
    for leaf in range(pm.tree.n_leaves):
        x = wg[:, codes[leaf]].T            # (n, S) eigen coords
        clvs[leaf] = np.repeat(x[:, None, :], C, axis=1).astype(np.float32)
    from plf_tpu.models.substitution import branch_matrices
    scaler = np.zeros(n, np.int64)
    for parent, l, r, tl, tr in pm.schedule:
        left = branch_matrices(pm.model, tl, pm.rates, C)
        right = branch_matrices(pm.model, tr, pm.rates, C)
        x3, sv, _ = plf_reference(clvs[l], clvs[r], left, right,
                                  pm.model.plf_ev)
        clvs[parent] = x3
        scaler += sv
    x_root = clvs[pm.tree.root]
    rows = np.repeat(pm.model.root_vector, C) / C
    xr = x_root.reshape(n, C, S)
    lane = np.transpose(xr, (2, 1, 0)).reshape(S * C, n)  # row = a*C+c
    lik = (rows[0].astype(np.float32) * lane[0]).astype(np.float32)
    for rrow in range(1, S * C):
        lik = lik + np.float32(rows[rrow]) * lane[rrow]

    assert int(np.sum(scaler * pm.wgt)) == fused.scaler_total
    np.testing.assert_allclose(fused.site_log_likelihood,
                               np.log(lik.astype(np.float64)),
                               rtol=0, atol=2e-6)


@pytest.mark.parametrize("n_sites", [100, 300, 1000])
def test_fused_sites_not_a_block_multiple(n_sites):
    """Site counts off the block grid: padding sites compute but never
    count a rescale or reach the result."""
    pm = _phylo(n_leaves=5, n_sites=n_sites, seed=n_sites)
    assert pm.n_pad % 128 == 0 and pm.n_pad > n_sites
    fused = pm.log_likelihood(method="fused")
    pernode = pm.log_likelihood(method="per-node")
    assert fused.site_log_likelihood.shape == (n_sites,)
    _assert_paths_agree(fused, pernode)


def test_fused_int8_codes_match_int32():
    p32 = _phylo(n_leaves=6, seed=4)
    p8 = _phylo(n_leaves=6, seed=4, tip_dtype="int8")
    assert p8._codes.dtype == np.int8
    r32 = p32.log_likelihood(method="fused")
    r8 = p8.log_likelihood(method="fused")
    np.testing.assert_array_equal(r8.site_log_likelihood,
                                  r32.site_log_likelihood)
    np.testing.assert_array_equal(r8.scaler_sites, r32.scaler_sites)


def test_fused_explicit_block_sizes_agree():
    """Every admissible power-of-two block gives the same sites."""
    pm = _phylo(n_leaves=5, n_sites=256, seed=3)
    lops, rops = pm._ops
    ops = np.stack([np.asarray(lops), np.asarray(rops)], axis=1)
    outs = [tree_triton.plf_tree_triton(
        pm._codes, pm._sched_r, ops, pm._ev, pm._tip_table, pm._root_rows,
        pm.n_sites, block_sites=bs, interpret=True)
        for bs in (64, 256)]
    for a, b in zip(*outs):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    with pytest.raises(ValueError, match="power of two"):
        tree_triton.plf_tree_triton(
            pm._codes, pm._sched_r, ops, pm._ev, pm._tip_table,
            pm._root_rows, pm.n_sites, block_sites=96, interpret=True)


# ------------------------------------------------------------ path choice ---

def test_kernel_request_without_interpret_raises_off_gpu():
    pm = _phylo(n_leaves=4, n_sites=128)
    pm_c = PhyloModel(pm.tree, pm.model, pm.tip_states, alpha=0.6,
                      config=PLFConfig(block_sites=128))
    assert jax.default_backend() != "gpu"
    with pytest.raises(ValueError, match="GPU backend"):
        pm_c.log_likelihood(method="fused")


def test_auto_takes_xla_traversal_off_gpu():
    pm = _phylo(n_leaves=5)
    assert pm.kernel_covers()
    assert pm.resolve_method("auto") == "per-node"
    assert pm.log_likelihood().method == "per-node"


@pytest.mark.parametrize("case,why", [
    ("protein", "states"), ("mxu", "variant"), ("xla", "backend"),
    ("pinv", "rows")])
def test_kernel_coverage(case, why):
    """Which models the kernel takes; an explicit request outside its
    coverage raises instead of silently running another path."""
    kw = dict(n_leaves=5, n_sites=128)
    if case == "protein":
        pm = _phylo(states=20, **kw)
    elif case == "mxu":
        pm = _phylo(kernel_variant="mxu", **kw)
    elif case == "xla":
        pm = _phylo(backend=Backend.XLA, **kw)
    else:
        tree = random_tree(5, seed=1)
        tips = np.random.default_rng(1).integers(0, 4, size=(5, 128))
        pm = PhyloModel(tree, hky85(2.0), tips, alpha=0.5, p_inv=0.2,
                        config=PLFConfig(block_sites=128, interpret=True))
        assert pm.config.rows == 20
    assert not pm.kernel_covers(), why
    assert pm.resolve_method("auto") == "per-node"
    with pytest.raises(ValueError, match="method='per-node'"):
        pm.log_likelihood(method="fused")


@pytest.mark.parametrize("n_pad,block,want", [
    (4096, 128, 128), (384, 128, 128), (384, 256, 128), (1 << 20, 512, 512),
    (4096, 300, 256), (640, 1024, 128), (4096, 256, 256)])
def test_choose_block(n_pad, block, want):
    """Blocks are the largest power of two up to the request that
    divides the padded sites."""
    got = tree_triton.choose_block(n_pad, block)
    assert got == want
    assert n_pad % got == 0 and got & (got - 1) == 0
    assert tree_triton.choose_block(4096) == tree_triton.DEFAULT_BLOCK


def test_kernel_compiles_once_per_shape_class():
    """The schedule is data: two topologies with the same edge, leaf and
    slot counts share one compiled kernel (tree search needs this)."""
    from plf_tpu.models.search import nni_neighbors
    pm = _phylo(n_leaves=8, n_sites=256, seed=2)
    slots = compile_register_schedule(pm._sched_r, 8)[1]
    other = next(t for t in nni_neighbors(pm.tree)
                 if compile_register_schedule(
                     reorder_schedule(t.schedule(), 8), 8)[1] == slots)
    pm2 = PhyloModel(other, pm.model, pm.tip_states, alpha=0.6,
                     config=pm.config)
    before = tree_triton._tree_call._cache_size()
    a = pm.log_likelihood(method="fused")
    mid = tree_triton._tree_call._cache_size()
    b = pm2.log_likelihood(method="fused")
    assert tree_triton._tree_call._cache_size() == mid <= before + 1
    assert a.log_likelihood != b.log_likelihood
    _assert_paths_agree(b, pm2.log_likelihood(method="per-node"))


# ------------------------------------------------------ other tree paths ---

def test_mxu_variant_per_node_traversal():
    tree = random_tree(6, seed=42)
    rng = np.random.default_rng(42)
    tips = rng.integers(0, 4, size=(6, 200))
    mxu = PLFConfig(block_sites=128, kernel_variant="mxu")
    pm = PhyloModel(tree, jc69(), tips, config=mxu)
    out = pm.log_likelihood(method="per-node")
    bf = pm.log_likelihood_bruteforce()
    assert abs(out.log_likelihood - bf) / abs(bf) < 1e-5


def test_sharded_tree_likelihood_matches_single_device():
    """Both paths over an 8-device site-sharded mesh == single device."""
    from plf_tpu.parallel import make_mesh
    pm = _phylo(n_leaves=6, n_sites=1500, seed=55)
    mesh = make_mesh()
    single = pm.log_likelihood(method="per-node")
    for method in ("fused", "per-node"):
        out = pm.log_likelihood_sharded(mesh, method=method)
        assert out.method == method
        assert out.scaler_total == single.scaler_total
        _assert_paths_agree(out, single)
        assert abs(out.log_likelihood - single.log_likelihood) < \
            1e-5 * abs(single.log_likelihood)


def test_sharded_tree_likelihood_large_tree_dynamic():
    n_leaves = 110
    tree = random_tree(n_leaves, seed=66)
    rng = np.random.default_rng(66)
    tips = rng.integers(0, 4, size=(n_leaves, 700))
    pm = PhyloModel(tree, jc69(), tips,
                    config=PLFConfig(block_sites=128, interpret=True))
    from plf_tpu.parallel import make_mesh
    out = pm.log_likelihood_sharded(make_mesh())
    bf = pm.log_likelihood_bruteforce()
    assert abs(out.log_likelihood - bf) / abs(bf) < 1e-4


def test_keep_root_clv_layout():
    """keep_root_clv returns the lane-major root CLV of the traversal."""
    pm = _phylo(n_leaves=5, n_sites=200)
    res = pm.log_likelihood(keep_root_clv=True)
    assert res.method == "per-node"
    x = np.asarray(res.root_clv, np.float64)
    assert x.shape == (16, pm.n_pad)
    rr = np.asarray(pm._root_rows, np.float64).reshape(-1)
    lik = rr @ x[:, :200]
    np.testing.assert_allclose(np.log(lik), res.site_log_likelihood,
                               rtol=1e-6)
    with pytest.raises(ValueError, match="root CLV"):
        pm.log_likelihood(keep_root_clv=True, method="fused")
