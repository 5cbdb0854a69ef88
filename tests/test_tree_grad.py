"""Gradients of the tree likelihood: autodiff of the XLA traversal
(tree_loglik_fn) against a float64 finite-difference oracle.

The oracle (conftest.bruteforce_loglik) prunes the tree in NumPy float64
with explicit P matrices — independent of every device path — so these
tests pin value AND gradient, single-device and site-sharded.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from plf_tpu.config import PLFConfig
from plf_tpu.models import PhyloModel, hky85, random_tree
from plf_tpu.models.optimize import tree_loglik_fn
from tests.conftest import bruteforce_loglik, fd_grad


def _make_pm(n_leaves=8, n=512, block=128, seed=0, alpha=0.5, **kw):
    tree = random_tree(n_leaves, seed=seed)
    rng = np.random.default_rng(seed)
    tips = rng.integers(0, 4, size=(n_leaves, n))
    return PhyloModel(tree, hky85(2.0), tips, alpha=alpha,
                      config=PLFConfig(block_sites=block), **kw)


def _grads(pm, **kw):
    fn, t0 = tree_loglik_fn(pm, **kw)
    val, g = jax.value_and_grad(fn)(jnp.asarray(t0))
    return float(val), np.asarray(g), t0


def _oracle(pm, t0):
    f = lambda t: bruteforce_loglik(pm, t)
    return f(t0), fd_grad(f, t0)


def test_tree_backend_value_matches_forward():
    pm = _make_pm()
    fn, t0 = tree_loglik_fn(pm)
    assert fn.engine == "xla" and fn.variant == "vpu"
    ll = float(fn(jnp.asarray(t0)))
    ref = pm.log_likelihood().log_likelihood
    assert ll == pytest.approx(ref, rel=1e-5)


def test_tree_grads_match_xla():
    """Autodiff gradient == float64 finite differences of the oracle."""
    pm = _make_pm()
    v, g, t0 = _grads(pm)
    v_o, g_o = _oracle(pm, t0)
    assert v == pytest.approx(v_o, rel=1e-5)
    np.testing.assert_allclose(g, g_o, rtol=2e-4, atol=1e-2)


def test_tree_grads_match_xla_underflow():
    # a deep caterpillar tree forces 2^32 rescales; the factor is
    # locally constant so gradients must still agree where the
    # likelihood is differentiable
    from plf_tpu.models import parse_newick

    n_leaves = 40
    newick = "A0:0.1"
    for i in range(1, n_leaves):
        newick = f"({newick},A{i}:0.1):0.1"
    tree = parse_newick(newick + ";")
    rng = np.random.default_rng(7)
    tips = rng.integers(0, 4, size=(n_leaves, 256))
    pm = PhyloModel(tree, hky85(2.0), tips, alpha=0.5,
                    config=PLFConfig(block_sites=128))
    assert pm.log_likelihood().scaler_total > 0, "case must rescale"
    v, g, t0 = _grads(pm)
    v_o, g_o = _oracle(pm, t0)
    assert v == pytest.approx(v_o, rel=1e-5)
    np.testing.assert_allclose(g, g_o, rtol=5e-4, atol=1e-2)


def test_tree_rates_and_weights_grads():
    pm = _make_pm(n_leaves=6, n=256, seed=2)
    fn, t0 = tree_loglik_fn(pm, with_weights=True)
    r = np.asarray(pm.rates, np.float64)
    w = np.asarray(pm.rate_weights, np.float64)
    gt, gr, gw = jax.grad(fn, argnums=(0, 1, 2))(
        jnp.asarray(t0), jnp.asarray(r, jnp.float32),
        jnp.asarray(w, jnp.float32))
    want = [fd_grad(lambda x: bruteforce_loglik(pm, x, r, w), t0),
            fd_grad(lambda x: bruteforce_loglik(pm, t0, x, w), r),
            fd_grad(lambda x: bruteforce_loglik(pm, t0, r, x), w)]
    for got, ref in zip((gt, gr, gw), want):
        np.testing.assert_allclose(np.asarray(got), ref, rtol=5e-4,
                                   atol=1e-2)


def test_tree_backend_with_gaps_and_weights():
    pm = _make_pm(n_leaves=8, n=300, block=128, seed=4)
    # gaps + pattern weights + a site count that needs padding
    tips = np.asarray(pm.tip_states).copy()
    tips[0, ::7] = -1
    wgt = np.asarray(np.arange(300) % 3 + 1, np.int32)
    pm2 = PhyloModel(pm.tree, pm.model, tips, wgt=wgt, alpha=0.5,
                     config=PLFConfig(block_sites=128))
    v, g, t0 = _grads(pm2)
    v_o, g_o = _oracle(pm2, t0)
    assert v == pytest.approx(v_o, rel=1e-5)
    np.testing.assert_allclose(g, g_o, rtol=5e-4, atol=1e-2)


def test_tree_backend_ascertainment():
    pm = _make_pm(n_leaves=6, n=200, block=128, seed=5,
                  ascertainment="lewis")
    v, g, t0 = _grads(pm)
    v_o, g_o = _oracle(pm, t0)
    assert v == pytest.approx(v_o, rel=1e-5)
    np.testing.assert_allclose(g, g_o, rtol=5e-4, atol=1e-2)


def test_tree_backend_sharded_grads_match():
    # site-sharded traversal (shard_map over a 4-device sites axis) must
    # reproduce the single-device gradients; operand cotangents cross
    # devices via shard_map's transpose-psum
    from plf_tpu.parallel.sharding import make_mesh

    pm = _make_pm(n_leaves=6, n=300, block=128, seed=6)
    v_m, g_m, t0 = _grads(pm, mesh=make_mesh(4))
    v_s, g_s, _ = _grads(pm)
    assert v_m == pytest.approx(v_s, rel=1e-6)
    np.testing.assert_allclose(g_m, g_s, rtol=1e-4, atol=1e-5)


def test_optimize_branch_lengths_sharded():
    from plf_tpu.models.optimize import optimize_branch_lengths
    from plf_tpu.parallel.sharding import make_mesh

    pm = _make_pm(n_leaves=6, n=256, block=128, seed=7)
    t_opt, ll0, ll1 = optimize_branch_lengths(
        pm, steps=20, mesh=make_mesh(4))
    assert ll1 > ll0
    assert np.all(t_opt > 0)


def test_loglik_fn_takes_alignment_as_arguments():
    """``fn(t, *data)``: one jitted gradient serves equal slices of one
    alignment, each matching the fn built for that slice alone."""
    tree = random_tree(6, seed=8)
    tips = np.random.default_rng(8).integers(0, 4, size=(6, 512))
    slices = [PhyloModel(tree, hky85(2.0), tips[:, k:k + 256], alpha=0.5,
                         config=PLFConfig(block_sites=128))
              for k in (0, 256)]
    fns = [tree_loglik_fn(pm) for pm in slices]
    (fn0, t0), (fn1, _) = fns
    step = jax.jit(jax.value_and_grad(fn0))
    t = jnp.asarray(t0)
    for fn, _ in fns:
        v, g = step(t, *fn.data)
        v_own, g_own = jax.value_and_grad(fn)(t)
        assert float(v) == pytest.approx(float(v_own), rel=1e-6)
        np.testing.assert_allclose(g, g_own, rtol=1e-5, atol=1e-6)
    assert step._cache_size() == 1
    assert float(fn1(t)) != pytest.approx(float(fn0(t)), rel=1e-6)
