"""Differentiable likelihood + branch-length optimisation tests."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from plf_tpu.config import Backend, PLFConfig
from plf_tpu.models import (PhyloModel, hky85, optimize_branch_lengths,
                            random_tree, tree_loglik_fn)


def _phylo(n_leaves=5, n_sites=200, seed=3):
    tree = random_tree(n_leaves, seed=seed)
    model = hky85(2.0, [0.3, 0.2, 0.3, 0.2])
    rng = np.random.default_rng(seed)
    tips = rng.integers(0, 4, size=(n_leaves, n_sites))
    cfg = PLFConfig(block_sites=128, interpret=True)
    return PhyloModel(tree, model, tips, alpha=0.6, config=cfg)


def test_loglik_fn_matches_phylo_model():
    pm = _phylo()
    fn, t0 = tree_loglik_fn(pm)
    ll = float(fn(jnp.asarray(t0)))
    ref = pm.log_likelihood().log_likelihood
    assert abs(ll - ref) < 1e-3 * abs(ref) + 0.5  # fp32 log/sum on device


def test_gradient_matches_finite_differences():
    pm = _phylo(n_leaves=4, n_sites=100)
    fn, t0 = tree_loglik_fn(pm)
    g = np.asarray(jax.grad(fn)(jnp.asarray(t0)))
    eps = 1e-3
    for i in range(len(t0)):
        tp = t0.copy(); tp[i] += eps
        tm = t0.copy(); tm[i] -= eps
        fd = (float(fn(jnp.asarray(tp))) - float(fn(jnp.asarray(tm)))) / (
            2 * eps)
        assert abs(g[i] - fd) < 5e-2 * max(1.0, abs(fd)), (i, g[i], fd)


def test_optimize_increases_likelihood():
    pm = _phylo(n_leaves=5, n_sites=150, seed=8)
    t_opt, ll0, ll1 = optimize_branch_lengths(pm, steps=60,
                                              learning_rate=0.05)
    assert ll1 > ll0
    assert (t_opt > 0).all()


def test_fit_model_improves_likelihood():
    """Gradient fit of GTR rates + frequencies + lengths on simulated
    data starting from a wrong model."""
    from plf_tpu.models import (fit_model, gtr, random_tree,
                                simulate_alignment)
    true_model = gtr([1.0, 3.0, 0.8, 1.2, 3.5, 1.0],
                     [0.35, 0.15, 0.25, 0.25])
    tree = random_tree(5, seed=4, mean_branch=0.25)
    tips = simulate_alignment(tree, true_model, 600, seed=5)
    wrong = gtr([1.0, 1.01, 0.99, 1.0, 1.02, 0.98],
                [0.25, 0.25, 0.25, 0.25])
    pm = _phylo()  # placeholder to reuse config; build proper below
    from plf_tpu.models import PhyloModel
    pm = PhyloModel(tree, wrong, tips,
                    config=PLFConfig(block_sites=128, interpret=True))
    fitted, t_opt, ll0, ll1 = fit_model(pm, steps=120, learning_rate=0.05)
    assert ll1 > ll0 + 1.0
    # fitted frequencies should move toward the truth
    err0 = np.abs(np.asarray(wrong.pi) - true_model.pi).sum()
    err1 = np.abs(np.asarray(fitted.pi) - true_model.pi).sum()
    assert err1 < err0


# ---------------------------------------------------------------------------
# Gamma shape (alpha) optimisation
# ---------------------------------------------------------------------------


def test_optimize_alpha_recovers_shape():
    """Alpha fitted on data simulated with a known shape should land
    nearer the truth than the (wrong) starting value, and improve ll."""
    from plf_tpu.models import optimize_alpha, simulate_alignment
    true_alpha = 0.4
    tree = random_tree(6, seed=21, mean_branch=0.3)
    model = hky85(2.0, [0.3, 0.2, 0.3, 0.2])
    tips = simulate_alignment(tree, model, 2000, alpha=true_alpha, seed=5)
    cfg = PLFConfig(block_sites=512, interpret=True)
    pm = PhyloModel(tree, model, tips, alpha=5.0, config=cfg)  # wrong start
    a_hat, ll0, ll1 = optimize_alpha(pm, iters=25)
    assert ll1 > ll0
    assert abs(np.log(a_hat) - np.log(true_alpha)) < abs(
        np.log(5.0) - np.log(true_alpha))


def test_tree_loglik_fn_with_rates_matches_fixed():
    pm = _phylo()
    fn_fixed, t0 = tree_loglik_fn(pm)
    fn_rates, _ = tree_loglik_fn(pm, with_rates=True)
    r = jnp.asarray(pm.rates, jnp.float32)
    assert float(fn_fixed(jnp.asarray(t0))) == float(
        fn_rates(jnp.asarray(t0), r))


def test_fit_model_with_alpha():
    from plf_tpu.models import fit_model, simulate_alignment
    tree = random_tree(5, seed=31, mean_branch=0.2)
    model = hky85(2.0)
    tips = simulate_alignment(tree, model, 500, alpha=0.5, seed=9)
    cfg = PLFConfig(block_sites=128, interpret=True)
    pm = PhyloModel(tree, model, tips, alpha=2.0, config=cfg)
    fitted, t_opt, ll0, ll1, a_hat = fit_model(
        pm, steps=40, learning_rate=0.05, fit_alpha=True, alpha_rounds=2)
    assert ll1 > ll0
    assert 0.02 < a_hat < 100.0
