"""Codon-model (61-state GY94) tests — the S-generic kernel stress case."""

import numpy as np
import pytest

from plf_tpu.config import Backend, PLFConfig
from plf_tpu.models import (PhyloModel, SENSE_CODONS, codon_gy94,
                            encode_codon_alignment, f3x4_frequencies,
                            random_tree)


def test_sense_codons_universal_code():
    assert len(SENSE_CODONS) == 61
    for stop in ("TAA", "TAG", "TGA"):
        assert stop not in SENSE_CODONS


def test_gy94_reversible_and_normalised():
    m = codon_gy94(kappa=2.5, omega=0.2,
                   pi=f3x4_frequencies(np.array(
                       [[.3, .2, .3, .2], [.25, .25, .25, .25],
                        [.2, .3, .2, .3]])))
    assert m.states == 61
    q = (m.u * m.eigenvalues[None, :]) @ m.w
    assert np.allclose(q.sum(axis=1), 0, atol=1e-9)
    # detailed balance
    f = m.pi[:, None] * q
    assert np.abs(f - f.T).max() < 1e-9
    # mean rate 1
    assert np.isclose(-np.sum(m.pi * np.diag(q)), 1.0)
    # multi-position changes are instantaneous-zero
    i = SENSE_CODONS.index("AAA")
    j = SENSE_CODONS.index("CCA")
    assert abs(q[i, j]) < 1e-9


def test_gy94_omega_affects_nonsynonymous_only():
    m1 = codon_gy94(kappa=2.0, omega=1.0)
    m2 = codon_gy94(kappa=2.0, omega=0.1)
    q1 = (m1.u * m1.eigenvalues[None, :]) @ m1.w
    q2 = (m2.u * m2.eigenvalues[None, :]) @ m2.w
    # synonymous pair: TTA/TTG (both Leu, transition at pos 3)
    i, j = SENSE_CODONS.index("TTA"), SENSE_CODONS.index("TTG")
    # overall normalisation differs, so compare the *ratio* structure:
    # nonsynonymous pair AAA(K)->AAT(N) shrinks relative to synonymous.
    k, l = SENSE_CODONS.index("AAA"), SENSE_CODONS.index("AAT")
    r1 = q1[k, l] / q1[i, j]
    r2 = q2[k, l] / q2[i, j]
    assert r2 < r1 * 0.2


def test_codon_tree_likelihood_matches_bruteforce():
    tree = random_tree(4, seed=61, mean_branch=0.15)
    m = codon_gy94(kappa=2.0, omega=0.3)
    rng = np.random.default_rng(61)
    tips = rng.integers(0, 61, size=(4, 40))
    cfg = PLFConfig(states=61, block_sites=128, interpret=True,
                    backend=Backend.XLA)
    pm = PhyloModel(tree, m, tips, alpha=0.8, config=cfg)
    ll = pm.log_likelihood().log_likelihood
    bf = pm.log_likelihood_bruteforce()
    assert np.isclose(ll, bf, rtol=2e-4), (ll, bf)


def test_codon_mxu_kernel_variant_interpret():
    """The 61-state model through the dot form of the traversal (mxu)
    matches the element-wise form."""
    tree = random_tree(4, seed=67, mean_branch=0.2)
    m = codon_gy94(kappa=1.5, omega=0.5)
    rng = np.random.default_rng(67)
    tips = rng.integers(0, 61, size=(4, 32))
    cfg_x = PLFConfig(states=61, block_sites=128, interpret=True,
                      backend=Backend.XLA)
    ll_x = PhyloModel(tree, m, tips, config=cfg_x
                      ).log_likelihood().log_likelihood
    cfg_p = PLFConfig(states=61, block_sites=128, interpret=True,
                      kernel_variant="mxu")
    ll_p = PhyloModel(tree, m, tips, config=cfg_p
                      ).log_likelihood(method="per-node").log_likelihood
    assert np.isclose(ll_x, ll_p, rtol=1e-5), (ll_x, ll_p)


def test_encode_codon_alignment_stops_and_gaps():
    dna = np.array([[0, 0, 0, 3, 2, 0, -1, 1, 2, 3, 0, 2]])
    # AAA | TGA(stop) | ?CG | TAG... wait TAG: T=3,A=0,G=2 -> stop
    cod = encode_codon_alignment(dna)
    assert SENSE_CODONS[cod[0, 0]] == "AAA"
    assert cod[0, 1] == 61   # TGA stop -> ambiguous
    assert cod[0, 2] == 61   # gap base
    assert cod[0, 3] == 61   # TAG stop


@pytest.mark.slow
def test_fit_codon_recovers_omega():
    """fit_codon recovers a simulated dN/dS (omega) and kappa within
    loose CI bounds — the end-to-end codon workflow (simulate under
    GY94, F3x4 from data, profile ML fit)."""
    from plf_tpu.models.optimize import fit_codon
    from plf_tpu.models.simulate import simulate_alignment
    from plf_tpu.models.substitution import f3x4_from_codes

    true_kappa, true_omega = 4.0, 0.2
    tree = random_tree(8, seed=5, mean_branch=0.2)
    m_true = codon_gy94(true_kappa, true_omega)
    tips = simulate_alignment(tree, m_true, 800, seed=3)

    cfg = PLFConfig(states=61, block_sites=128, kernel_variant="mxu")
    model, info = fit_codon(tree, tips, config=cfg, rounds=2, iters=8,
                            length_steps=30)
    # uniform-pi data: F3x4 estimate should be near-uniform
    pi = f3x4_from_codes(tips)
    assert pi.shape == (61,) and abs(pi.sum() - 1) < 1e-9
    assert 0.08 < info["omega"] < 0.45, info
    assert 2.0 < info["kappa"] < 8.0, info
    # fitted model beats an omega=1 null at the same lengths
    from plf_tpu.models.phylo import PhyloModel as PM
    ll_fit = info["ll"]
    pm_null = PM(info["tree"], codon_gy94(info["kappa"], 1.0,
                                          info["pi"]),
                 tips, config=cfg)
    assert ll_fit > pm_null.log_likelihood().log_likelihood


def test_f3x4_from_codes_recovers_biased_frequencies():
    """Positional nucleotide bias in the data shows up in the F3x4
    estimate (and gaps are ignored)."""
    from plf_tpu.models.substitution import (SENSE_CODONS,
                                             f3x4_from_codes)
    # alignment of pure "AAA" plus gap codes
    idx = SENSE_CODONS.index("AAA")
    codes = np.full((3, 50), idx, np.int32)
    codes[:, -5:] = 61   # gaps
    pi = f3x4_from_codes(codes)
    assert pi[idx] > 0.99
