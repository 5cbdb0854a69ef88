"""Kernel variants (dot algorithms) through the traversal and its gradient.

The dot variants ("mxu" = F32_F32_F32, "mxu_3x" = BF16_BF16_F32_X3)
reach both the forward XLA traversal and its autodiff; values and
gradients are held against the float64 brute-force oracle
(conftest.bruteforce_loglik) at each algorithm's accuracy class.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from plf_tpu.config import PLFConfig
from plf_tpu.models import PhyloModel, hky85, random_tree
from plf_tpu.models.optimize import tree_loglik_fn
from plf_tpu.models.substitution import random_gtr
from tests.conftest import bruteforce_loglik, fd_grad


def _make_pm(n_leaves=6, n=200, block=128, seed=0, states=4,
             variant="mxu", categories=4):
    tree = random_tree(n_leaves, seed=seed)
    model = hky85(2.0) if states == 4 else random_gtr(states, seed)
    rng = np.random.default_rng(seed)
    tips = rng.integers(0, states, size=(n_leaves, n))
    cfg = PLFConfig(states=states, categories=categories,
                    block_sites=block, kernel_variant=variant)
    return PhyloModel(tree, model, tips, alpha=0.5, config=cfg)


def _check_against_oracle(pm, rel, rtol, atol):
    fn, t0 = tree_loglik_fn(pm)
    v, g = jax.value_and_grad(fn)(jnp.asarray(t0))
    f = lambda t: bruteforce_loglik(pm, t)
    assert float(v) == pytest.approx(f(t0), rel=rel)
    np.testing.assert_allclose(np.asarray(g), fd_grad(f, t0), rtol=rtol,
                               atol=atol)
    return fn


@pytest.mark.parametrize("variant", ["mxu", "mxu_3x"])
def test_tree_backend_mxu_grads_match_xla(variant):
    """DNA at each dot variant: value and gradient vs the oracle."""
    fn = _check_against_oracle(_make_pm(variant=variant), 1e-5, 5e-4,
                               1e-2)
    assert (fn.engine, fn.variant) == ("xla", variant)


def test_tree_backend_mxu_protein_grads():
    pm = _make_pm(n_leaves=5, n=100, states=20, variant="mxu",
                  categories=2)
    _check_against_oracle(pm, 1e-5, 5e-4, 1e-2)


def test_tree_backend_mxu_underflow_rescale_grads():
    """Deep caterpillar forces 2^32 rescales; the factor is locally
    constant so dot-variant gradients must still match the oracle."""
    from plf_tpu.models import parse_newick

    n_leaves = 24
    newick = "A0:0.1"
    for i in range(1, n_leaves):
        newick = f"({newick},A{i}:0.1):0.1"
    tree = parse_newick(newick + ";")
    rng = np.random.default_rng(7)
    tips = rng.integers(0, 4, size=(n_leaves, 256))
    pm = PhyloModel(tree, hky85(2.0), tips, alpha=0.5,
                    config=PLFConfig(block_sites=128,
                                     kernel_variant="mxu"))
    assert pm.log_likelihood().scaler_total > 0, "case must rescale"
    _check_against_oracle(pm, 1e-5, 5e-4, 1e-2)


@pytest.mark.parametrize("variant", ["mxu", "mxu_3x"])
def test_dot_variant_forward_matches_elementwise(variant):
    """The traversal's dot form against its element-wise form (per-site
    ll, scaler counts equal)."""
    res = {}
    for v in ("vpu", variant):
        res[v] = _make_pm(n_leaves=12, n=300, variant=v,
                          seed=3).log_likelihood()
    assert res[variant].scaler_total == res["vpu"].scaler_total
    np.testing.assert_allclose(res[variant].site_log_likelihood,
                               res["vpu"].site_log_likelihood,
                               rtol=1e-5 if variant == "mxu" else 1e-4)


def test_protein_mxu_3x_grads():
    pm = _make_pm(n_leaves=6, n=100, states=20, variant="mxu_3x",
                  categories=2, seed=5)
    _check_against_oracle(pm, 1e-4, 2e-3, 5e-2)


def test_resolved_variant_auto_protein_is_mxu_3x():
    assert PLFConfig(states=20, kernel_variant="auto"
                     ).resolved_kernel_variant == "mxu_3x"
    assert PLFConfig(states=4, kernel_variant="auto"
                     ).resolved_kernel_variant == "vpu"


def test_training_reports_engine_and_variant():
    """fn.engine / fn.variant name the path the gradient runs: the XLA
    traversal, at the configured variant (auto S=20 -> mxu_3x)."""
    pm = _make_pm(n_leaves=5, n=100, states=20, variant="auto",
                  categories=2)
    fn, _ = tree_loglik_fn(pm)
    assert (fn.engine, fn.variant) == ("xla", "mxu_3x")
    pm4 = _make_pm(n_leaves=5, n=100, variant="vpu")
    fn4, _ = tree_loglik_fn(pm4)
    assert (fn4.engine, fn4.variant) == ("xla", "vpu")
    with pytest.raises(ValueError, match="mxu_bf16"):
        tree_loglik_fn(_make_pm(n_leaves=5, n=100, variant="mxu_bf16"))


@pytest.mark.slow
def test_mxu3x_accuracy_depth_ladder():
    """mxu_3x error does not compound with tree depth: ll drift against
    the element-wise (vpu) traversal stays ~1e-5-class from 8 to 256
    taxa (per-site rounding averages out), and the autodiff gradient
    drift at 256 taxa against the full-fp32 dots (mxu) stays in the
    1e-3..1e-2 class: the basis for mxu_3x being the S>=20 default
    (config.resolved_kernel_variant).  The gradient's anchor is mxu, not
    vpu: the element-wise S=20 form unrolls 3 x 20 stages per node, and
    its 256-taxon gradient takes over ten minutes to compile here."""
    from plf_tpu.models.substitution import empirical_protein

    lg = empirical_protein("lg")
    ll_bounds = {8: 5e-5, 64: 5e-5, 256: 5e-5}
    for n_taxa, bound in ll_bounds.items():
        tree = random_tree(n_taxa, seed=7, mean_branch=0.12)
        tips = np.random.default_rng(1).integers(
            0, 20, size=(n_taxa, 256))
        lls = {}
        for v in ("vpu", "mxu_3x"):
            cfg = PLFConfig(states=20, block_sites=128,
                            kernel_variant=v)
            pm = PhyloModel(tree, lg, tips, alpha=0.8, config=cfg)
            lls[v] = pm.log_likelihood(
                method="per-node").log_likelihood
        drift = abs(lls["mxu_3x"] - lls["vpu"]) / abs(lls["vpu"])
        assert drift < bound, (n_taxa, drift)
    # gradient drift at full depth (256 taxa) stays bounded
    tree = random_tree(256, seed=7, mean_branch=0.12)
    tips = np.random.default_rng(1).integers(0, 20, size=(256, 256))
    g = {}
    for v in ("mxu", "mxu_3x"):
        cfg = PLFConfig(states=20, block_sites=128, kernel_variant=v)
        pm = PhyloModel(tree, lg, tips, alpha=0.8, config=cfg)
        fn, t0 = tree_loglik_fn(pm)
        _, g[v] = jax.value_and_grad(fn)(jnp.asarray(t0))
    rms = float(jnp.linalg.norm(g["mxu_3x"] - g["mxu"])
                / jnp.linalg.norm(g["mxu"]))
    assert rms < 2e-2, rms
