"""Model-layer tests: substitution models, trees, whole-tree likelihood."""

import numpy as np
import pytest

from plf_tpu.config import Backend, PLFConfig
from plf_tpu.models import (PhyloModel, branch_matrices,
                            discrete_gamma_rates, gtr, hky85, jc69,
                            parse_newick, random_gtr, random_tree)


# ----------------------------------------------------------- substitution --

@pytest.mark.parametrize("model_fn", [jc69, lambda: hky85(2.5),
                                      lambda: random_gtr(4, 1),
                                      lambda: random_gtr(20, 2)])
def test_eigensystem_reconstructs_q(model_fn):
    m = model_fn()
    # P(0) = I; rows of P(t) sum to 1; pi is stationary.
    np.testing.assert_allclose(m.p_matrix(0.0), np.eye(m.states), atol=1e-10)
    P = m.p_matrix(0.37)
    np.testing.assert_allclose(P.sum(axis=1), 1.0, atol=1e-10)
    np.testing.assert_allclose(m.pi @ P, m.pi, atol=1e-10)
    assert (P >= -1e-12).all()


def test_gamma_rates_mean_one():
    for alpha in (0.1, 0.5, 1.0, 10.0):
        r = discrete_gamma_rates(alpha)
        assert r.shape == (4,)
        np.testing.assert_allclose(r.mean(), 1.0, atol=1e-12)
        assert (np.diff(r) > 0).all()


def test_branch_matrix_factorisation():
    """left/EV factoring must reproduce the full P-matrix action."""
    m = hky85(2.0, [0.3, 0.2, 0.3, 0.2])
    rates = discrete_gamma_rates(0.8)
    left = branch_matrices(m, 0.21, rates).astype(np.float64)
    rng = np.random.default_rng(3)
    Lstate = rng.random((5, 4))
    x = Lstate @ m.w.T          # eigen coords
    for c in range(4):
        got = np.einsum("ka,na->nk", left[c], x)
        want = Lstate @ m.p_matrix(0.21, rates[c]).T
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-12)


# ------------------------------------------------------------------ trees --

def test_parse_newick_roundtrip_structure():
    t = parse_newick("((A:0.1,B:0.2):0.05,(C:0.3,D:0.1):0.02);")
    assert t.n_leaves == 4
    assert sorted(t.leaf_names()) == ["A", "B", "C", "D"]
    sched = t.schedule()
    assert len(sched) == 3  # 4 leaves -> 3 internal nodes
    # parents appear after their children
    seen = set(range(4))
    for parent, l, r, _, _ in sched:
        assert l in seen and r in seen
        seen.add(parent)


def test_parse_newick_multifurcation_binarised():
    t = parse_newick("(A:0.1,B:0.2,C:0.3);")
    assert t.n_leaves == 3
    assert len(t.schedule()) == 2  # binarised with a zero-length connector


def test_random_tree_valid():
    t = random_tree(17, seed=5)
    assert t.n_leaves == 17
    assert len(t.schedule()) == 16
    levels = t.levels()
    assert sum(len(l) for l in levels) == 16


# ------------------------------------------------------------- likelihood --

def _make_phylo(n_leaves=6, n_sites=400, alpha=0.7, backend=Backend.PALLAS,
                states=4, seed=11):
    tree = random_tree(n_leaves, seed=seed)
    model = hky85(2.0, [0.3, 0.2, 0.3, 0.2]) if states == 4 else \
        random_gtr(states, seed)
    rng = np.random.default_rng(seed)
    tips = rng.integers(0, states, size=(n_leaves, n_sites))
    tips[0, :5] = -1  # some gaps
    cfg = PLFConfig(states=states, block_sites=128, interpret=True,
                    backend=backend)
    return PhyloModel(tree, model, tips, alpha=alpha, config=cfg)


def test_tree_likelihood_matches_bruteforce():
    pm = _make_phylo()
    out = pm.log_likelihood()
    bf = pm.log_likelihood_bruteforce()
    assert out.scaler_total >= 0
    assert abs(out.log_likelihood - bf) / abs(bf) < 1e-5


def test_tree_likelihood_backends_agree():
    pallas = _make_phylo(backend=Backend.PALLAS).log_likelihood()
    xla = _make_phylo(backend=Backend.XLA).log_likelihood()
    assert abs(pallas.log_likelihood - xla.log_likelihood) < 1e-3


def test_tree_likelihood_weights():
    pm = _make_phylo()
    base = pm.log_likelihood().log_likelihood
    tree, model = pm.tree, pm.model
    w = np.full(pm.n_sites, 2, np.int32)
    pm2 = PhyloModel(tree, model, pm.tip_states, wgt=w, alpha=0.7,
                     config=pm.config)
    doubled = pm2.log_likelihood().log_likelihood
    assert abs(doubled - 2 * base) < 1e-6 * abs(base) + 1e-3


def test_deep_tree_underflow_rescaling():
    """A deep caterpillar tree underflows fp32 site likelihoods without
    rescaling; the scaler path must keep the log-likelihood finite and
    matching the float64 oracle."""
    n_leaves = 40
    newick = "A0:0.1"
    for i in range(1, n_leaves):
        newick = f"({newick},A{i}:0.1):0.1"
    tree = parse_newick(newick + ";")
    model = jc69()
    rng = np.random.default_rng(7)
    tips = rng.integers(0, 4, size=(n_leaves, 300))
    pm = PhyloModel(tree, model, tips,
                    config=PLFConfig(block_sites=128, interpret=True))
    out = pm.log_likelihood()
    assert np.isfinite(out.log_likelihood)
    assert out.scaler_total > 0, "deep tree should trigger rescaling"
    bf = pm.log_likelihood_bruteforce()
    assert abs(out.log_likelihood - bf) / abs(bf) < 1e-4


def test_protein_tree_likelihood():
    pm = _make_phylo(n_leaves=4, n_sites=150, states=20)
    out = pm.log_likelihood()
    bf = pm.log_likelihood_bruteforce()
    assert abs(out.log_likelihood - bf) / abs(bf) < 1e-5


def test_simulate_alignment_and_likelihood():
    """Simulated data: valid codes, and the generating tree beats a tree
    with shuffled branch lengths on likelihood."""
    from plf_tpu.models import simulate_alignment
    from plf_tpu.models.tree import Tree, TreeNode
    tree = random_tree(6, seed=20)
    model = hky85(2.0, [0.3, 0.2, 0.3, 0.2])
    tips = simulate_alignment(tree, model, 800, alpha=0.8, seed=3)
    assert tips.shape == (6, 800)
    assert tips.min() >= 0 and tips.max() <= 3
    cfg = PLFConfig(block_sites=128, interpret=True)
    ll_true = PhyloModel(tree, model, tips, alpha=0.8,
                         config=cfg).log_likelihood().log_likelihood
    # same topology, badly perturbed branch lengths
    nodes = [TreeNode(n.index, n.name, n.length * 20 + 1.0, n.children)
             for n in tree.nodes]
    bad = Tree(nodes=nodes, root=tree.root)
    ll_bad = PhyloModel(bad, model, tips, alpha=0.8,
                        config=cfg).log_likelihood().log_likelihood
    assert ll_true > ll_bad


# ---------------------------------------------------------------------------
# Ascertainment-bias (Lewis) correction
# ---------------------------------------------------------------------------


def test_lewis_correction_matches_manual():
    """PhyloModel(ascertainment='lewis') equals the hand-assembled
    correction: ll - W*log(1 - sum_s P(constant site s))."""
    tree = random_tree(5, seed=17, mean_branch=0.2)
    model = hky85(2.0, [0.3, 0.2, 0.3, 0.2])
    rng = np.random.default_rng(17)
    tips = rng.integers(0, 4, size=(5, 150))
    cfg = PLFConfig(block_sites=128, interpret=True)

    plain = PhyloModel(tree, model, tips, alpha=0.7, config=cfg)
    res_plain = plain.log_likelihood()

    const = np.tile(np.arange(4), (5, 1))
    pconst_model = PhyloModel(tree, model, const, alpha=0.7, config=cfg)
    res_c = pconst_model.log_likelihood()
    # shallow tree: no rescales on constant sites
    assert res_c.scaler_total == 0
    p_const = float(np.exp(res_c.site_log_likelihood).sum())
    expected = (res_plain.log_likelihood
                - 150 * np.log1p(-p_const))

    asc = PhyloModel(tree, model, tips, alpha=0.7, config=cfg,
                     ascertainment="lewis")
    got = asc.log_likelihood()
    assert np.isclose(got.log_likelihood, expected, rtol=1e-6)
    assert got.site_log_likelihood.shape == (150,)
    # per-site corrected ll
    assert np.allclose(
        got.site_log_likelihood,
        res_plain.site_log_likelihood - np.log1p(-p_const), rtol=1e-6)


def test_lewis_correction_fused_vs_pernode():
    tree = random_tree(6, seed=19, mean_branch=0.15)
    model = hky85(1.5)
    rng = np.random.default_rng(19)
    tips = rng.integers(0, 4, size=(6, 100))
    cfg = PLFConfig(block_sites=128, interpret=True)
    asc = PhyloModel(tree, model, tips, config=cfg, ascertainment="lewis")
    ll_fused = asc.log_likelihood(method="fused").log_likelihood
    ll_node = asc.log_likelihood(method="per-node").log_likelihood
    assert np.isclose(ll_fused, ll_node, rtol=1e-6)


def test_lewis_correction_gradient_path():
    """tree_loglik_fn applies the same correction (so optimisers see the
    corrected objective) and stays differentiable."""
    import jax
    import jax.numpy as jnp
    from plf_tpu.models import tree_loglik_fn
    tree = random_tree(4, seed=23, mean_branch=0.2)
    model = hky85(2.0)
    rng = np.random.default_rng(23)
    tips = rng.integers(0, 4, size=(4, 80))
    cfg = PLFConfig(block_sites=128, interpret=True)
    asc = PhyloModel(tree, model, tips, config=cfg, ascertainment="lewis")
    fn, t0 = tree_loglik_fn(asc)
    ll = float(fn(jnp.asarray(t0)))
    ref = asc.log_likelihood().log_likelihood
    assert abs(ll - ref) < 1e-3 * abs(ref) + 0.5
    g = np.asarray(jax.grad(fn)(jnp.asarray(t0)))
    assert np.isfinite(g).all()


def test_finalise_ll_floors_negative_site_likelihoods():
    """The 1-pass bf16 fast mode can round near-underflow site
    likelihoods NEGATIVE through deep trees (observed on hardware,
    RESULTS.md round 3); _finalise_ll must floor before the log so the
    result is a finite deterministic penalty, never NaN."""
    rng = np.random.default_rng(0)
    tips = rng.integers(0, 4, size=(4, 8)).astype(np.int32)
    pm = PhyloModel(random_tree(4, seed=1), hky85(2.0), tips,
                    config=PLFConfig(block_sites=128))
    lik = np.array([0.5, -1e-40, 0.0, 1e-30, 0.25, 0.1, 0.2, 0.3])
    res = pm._finalise_ll(lik, np.zeros(8, np.int64), 0)
    assert np.all(np.isfinite(res.site_log_likelihood))
    # floor = FLT_MIN (a NORMAL fp32: subnormal floors flush to zero
    # under XLA flush-to-zero and reintroduce log(0) = -inf on device
    # paths)
    from plf_tpu.models.phylo import LIK_FLOOR
    assert res.site_log_likelihood[1] == res.site_log_likelihood[2] == (
        np.log(LIK_FLOOR))
    # sub-floor but positive sites floor too (1e-30 > FLT_MIN: kept)
    assert np.isclose(res.site_log_likelihood[3], np.log(1e-30))
