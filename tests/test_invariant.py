"""+I / +I+G invariant-sites mixture: engine paths vs independent oracle."""

import numpy as np
import pytest

from plf_tpu.models import (PhyloModel, jc69, hky85, random_tree,
                            simulate_alignment, gamma_invariant_rates,
                            optimize_pinv, optimize_alpha)
from plf_tpu.models.phylo import LOG_MINLIK


def oracle_ll(tree, model, tips, rates, weights):
    """Independent fp64 pruning using only model.p_matrix."""
    S = model.states
    C = len(rates)
    n = tips.shape[1]
    partial = {}
    for leaf in range(tree.n_leaves):
        onehot = np.zeros((n, S))
        si = tips[leaf]
        valid = (si >= 0) & (si < S)
        onehot[np.arange(n)[valid], si[valid]] = 1.0
        onehot[~valid] = 1.0
        partial[leaf] = np.repeat(onehot[:, None, :], C, axis=1)
    for parent, l, r, tl, tr in tree.schedule():
        out = np.empty((n, C, S))
        for c in range(C):
            P1 = model.p_matrix(tl, rates[c])
            P2 = model.p_matrix(tr, rates[c])
            out[:, c, :] = (partial[l][:, c, :] @ P1.T) * (
                partial[r][:, c, :] @ P2.T)
        partial[parent] = out
    lik = (partial[tree.root] @ model.pi) @ weights
    return float(np.sum(np.log(lik)))


@pytest.mark.parametrize("alpha", [None, 0.7])
def test_pinv_matches_oracle(alpha):
    tree = random_tree(6, seed=0, mean_branch=0.12)
    model = hky85(2.5)
    tips = simulate_alignment(tree, model, n_sites=400, alpha=alpha,
                              p_inv=0.3, seed=1)
    pm = PhyloModel(tree, model, tips, alpha=alpha, p_inv=0.3)
    rates, weights = gamma_invariant_rates(alpha, 0.3, 4)
    want = oracle_ll(tree, model, tips, rates, weights)

    # Every evaluation path must agree with the oracle (the whole-tree
    # kernel does not take the 5-category +I model: auto runs the XLA
    # traversal).
    for method in ("auto", "per-node"):
        res = pm.log_likelihood(method=method)
        assert res.log_likelihood == pytest.approx(want, abs=2e-3)
    assert pm.log_likelihood_bruteforce() == pytest.approx(want, abs=1e-8)


def test_pinv_zero_weight_equals_plain_gamma():
    tree = random_tree(5, seed=2)
    model = jc69()
    tips = simulate_alignment(tree, model, n_sites=200, alpha=0.5, seed=3)
    plain = PhyloModel(tree, model, tips, alpha=0.5).log_likelihood()
    # p_inv ~ 0: the invariant category carries ~no weight.
    pinv = PhyloModel(tree, model, tips, alpha=0.5,
                      p_inv=1e-9).log_likelihood()
    assert pinv.log_likelihood == pytest.approx(plain.log_likelihood,
                                                abs=1e-4)


def test_rate_weights_explicit():
    tree = random_tree(5, seed=4)
    model = jc69()
    tips = simulate_alignment(tree, model, n_sites=150, seed=5)
    w = np.array([0.4, 0.3, 0.2, 0.1])
    rates = np.array([0.2, 0.8, 1.2, 1.8])
    # bruteforce recomputes P matrices from pm.rates at call time, so the
    # explicit-rates mixture can be checked against the oracle directly.
    pm2 = PhyloModel(tree, model, tips, rate_weights=w)
    pm2.rates = rates
    want = oracle_ll(tree, model, tips, pm2.rates, w)
    assert pm2.log_likelihood_bruteforce() == pytest.approx(want, abs=1e-8)
    with pytest.raises(ValueError):
        PhyloModel(tree, model, tips, rate_weights=np.array([0.5, 0.5]))
    with pytest.raises(ValueError):
        PhyloModel(tree, model, tips, p_inv=0.2,
                   rate_weights=np.full(4, 0.25))


def test_optimize_pinv_recovers_signal():
    tree = random_tree(6, seed=6, mean_branch=0.15)
    model = jc69()
    # Strongly invariant data -> optimiser should find high p_inv and
    # improve the likelihood over the 0.1 start.
    tips = simulate_alignment(tree, model, n_sites=600, p_inv=0.5, seed=7)
    pm = PhyloModel(tree, model, tips, p_inv=0.1)
    p_hat, ll0, ll1 = optimize_pinv(pm, iters=25)
    assert ll1 >= ll0
    assert 0.2 < p_hat < 0.8
    # And alpha search still works on a +I model (C-1 gamma categories).
    a_hat, a0, a1 = optimize_alpha(pm, iters=10)
    assert a1 >= a0 - 1e-6
