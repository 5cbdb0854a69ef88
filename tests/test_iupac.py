"""IUPAC partial-ambiguity tip states (R -> {A,G} multi-hot CLVs).

RAxML expands partial ambiguity codes to multi-hot tip vectors (the
reference kernel consumes arbitrary tip CLVs,
/root/reference/app/src/plf.cpp:21-22); round 2 collapsed every
ambiguity code to a full gap, silently losing data.  These tests pin the
fixed semantics across every evaluation path.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from plf_tpu.config import PLFConfig
from plf_tpu.io.alignment import (AMBIGUITY, encode_dna, encode_protein,
                                  map_tip_codes, tip_expansion_table)
from plf_tpu.models import PhyloModel, hky85, random_tree
from tests.conftest import bruteforce_loglik, fd_grad
from plf_tpu.models.optimize import tree_loglik_fn


def test_encode_dna_iupac_codes():
    codes = encode_dna(["ACGTRYSWKMBDHVN-ac"])
    assert codes.tolist() == [[0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12,
                               13, -1, -1, 0, 1]]


def test_encode_protein_ambiguity_codes():
    codes = encode_protein(["ARBZJX-"])
    assert codes.tolist() == [[0, 1, 20, 21, 22, -1, -1]]


def test_map_tip_codes_shifts_past_gap_column():
    ts = np.asarray([[0, 3, 4, 13, -1, 99]])
    out = map_tip_codes(ts, 4)
    # states keep, ambiguity 4..13 -> 5..14, gap/invalid -> 4
    assert out.tolist() == [[0, 3, 5, 14, 4, 4]]


def test_tip_expansion_table_columns():
    rng = np.random.default_rng(0)
    w = rng.random((4, 4))
    tbl = tip_expansion_table(w, 4)
    assert tbl.shape == (4, 4 + 1 + 10)
    np.testing.assert_allclose(tbl[:, 4], w.sum(axis=1))
    # column for R (= {A, G} = states 0, 2) is w[:,0] + w[:,2]
    np.testing.assert_allclose(tbl[:, 5], w[:, 0] + w[:, 2])
    # column for V (= {A, C, G}) is the last
    np.testing.assert_allclose(tbl[:, 14], w[:, (0, 1, 2)].sum(axis=1))


def _pm_with_codes(tips, seed=0, **kw):
    n_leaves = tips.shape[0]
    tree = random_tree(n_leaves, seed=seed)
    return PhyloModel(tree, hky85(2.0), tips, alpha=0.5,
                      config=PLFConfig(block_sites=128), **kw)


def test_ambiguity_changes_likelihood_vs_gap():
    rng = np.random.default_rng(1)
    tips = rng.integers(0, 4, size=(6, 200))
    tips_r = tips.copy()
    tips_r[2, ::5] = 4            # R at every 5th site of one leaf
    tips_g = tips.copy()
    tips_g[2, ::5] = -1           # same sites fully gapped
    ll_r = _pm_with_codes(tips_r).log_likelihood().log_likelihood
    ll_g = _pm_with_codes(tips_g).log_likelihood().log_likelihood
    assert ll_r != pytest.approx(ll_g, abs=1e-3)
    # R = {A,G} is MORE informative than a gap: likelihood must drop
    assert ll_r < ll_g


def test_ambiguity_matches_bruteforce_oracle():
    rng = np.random.default_rng(2)
    tips = rng.integers(0, 4, size=(5, 64))
    tips[1, ::3] = rng.integers(4, 14, size=tips[1, ::3].shape)  # IUPAC mix
    tips[3, ::7] = -1
    pm = _pm_with_codes(tips)
    ll = pm.log_likelihood().log_likelihood
    oracle = pm.log_likelihood_bruteforce()
    assert ll == pytest.approx(oracle, rel=1e-5)


def test_ambiguity_same_across_paths():
    rng = np.random.default_rng(3)
    tips = rng.integers(0, 4, size=(9, 300))
    tips[0, ::4] = 5              # Y
    tips[4, 1::6] = 10            # B
    pm = PhyloModel(random_tree(9, seed=0), hky85(2.0), tips, alpha=0.5,
                    config=PLFConfig(block_sites=128, interpret=True))
    res_f = pm.log_likelihood(method="fused")
    res_p = pm.log_likelihood(method="per-node")
    assert res_f.log_likelihood == pytest.approx(res_p.log_likelihood,
                                                 rel=1e-7)
    assert res_f.scaler_total == res_p.scaler_total


def test_ambiguity_gradients_consistent():
    rng = np.random.default_rng(4)
    tips = rng.integers(0, 4, size=(6, 256))
    tips[2, ::5] = 4
    pm = _pm_with_codes(tips)
    fn, t0 = tree_loglik_fn(pm)
    v, g = jax.value_and_grad(fn)(jnp.asarray(t0))
    f = lambda t: bruteforce_loglik(pm, t)
    assert float(v) == pytest.approx(f(t0), rel=1e-5)
    np.testing.assert_allclose(np.asarray(g), fd_grad(f, t0), rtol=5e-4,
                               atol=1e-2)


def test_protein_ambiguity_bruteforce():
    from plf_tpu.models.substitution import empirical_protein

    rng = np.random.default_rng(5)
    n_leaves = 4
    tips = rng.integers(0, 20, size=(n_leaves, 40))
    tips[1, ::4] = 20             # B = {N, D}
    tips[2, 1::5] = 21            # Z = {Q, E}
    tree = random_tree(n_leaves, seed=5)
    pm = PhyloModel(tree, empirical_protein("wag"), tips, alpha=0.7,
                    config=PLFConfig(states=20, block_sites=128,
                                     kernel_variant="vpu"))
    ll = pm.log_likelihood(method="per-node").log_likelihood
    oracle = pm.log_likelihood_bruteforce()
    assert ll == pytest.approx(oracle, rel=1e-4)


def test_tip_table_trims_to_observed_codes():
    """The kernel tip table trims to the observed code range (plain +
    gap when the data has no ambiguity codes; full width when IUPAC
    codes are present) — and both paths stay exact vs brute force."""
    from plf_tpu.config import PLFConfig
    from plf_tpu.models import PhyloModel, hky85, random_tree

    tree = random_tree(5, seed=3)
    cfg = PLFConfig(block_sites=128, interpret=True)
    plain = np.random.default_rng(1).integers(0, 4, size=(5, 200))
    pm = PhyloModel(tree, hky85(2.0), plain, alpha=0.6, config=cfg)
    assert pm._tip_ncols == 5             # ACGT + gap only
    assert pm._tip_table.shape[-1] == 5
    ll = pm.log_likelihood(method="fused").log_likelihood
    assert np.isclose(ll, pm.log_likelihood_bruteforce(), rtol=1e-5)

    # same data with one ambiguity code -> its column range is kept
    amb = plain.copy()
    amb[0, 0] = 5            # maps to internal ambiguity code 6
    pm2 = PhyloModel(tree, hky85(2.0), amb, alpha=0.6, config=cfg)
    assert pm2._tip_ncols == 7
    ll2 = pm2.log_likelihood(method="fused").log_likelihood
    assert np.isclose(ll2, pm2.log_likelihood_bruteforce(), rtol=1e-5)
