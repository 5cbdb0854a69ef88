"""Test environment: force CPU jax with an 8-device virtual mesh.

The analogue of the reference's emulation ladder (sw_emu/hw_emu,
README.md:137-146; app/src/include.h:103-117): all correctness tests run
on the CPU — the whole-tree Triton kernel in the Pallas interpreter —
with XLA's host-platform device-count flag providing 8 virtual devices
so the multi-device sharding path is exercised without a GPU host.
Tests that need a GPU take the ``gpu`` fixture (and the ``gpu`` marker):
it skips them here and runs them on a card.
"""

import os

# Must run before jax is imported anywhere.
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()
os.environ["JAX_PLATFORMS"] = "cpu"

import jax

jax.config.update("jax_platforms", "cpu")

import numpy as np
import pytest

# ---------------------------------------------------------------------------
# Fast/slow split: the default run (`pytest -q`) deselects tests marked slow
# (pyproject addopts `-m "not slow"`) and stays under ~a minute for kernel-
# iteration loops; the FULL suite runs with `pytest -m ""` (nightly-style /
# judge runs).  Marking is centralised here by nodeid prefix, measured from
# `--durations` (everything > ~3s lands in the slow set); every subsystem
# keeps at least one fast test.
# ---------------------------------------------------------------------------
SLOW_TESTS = (
    "test_ancestral.py::test_site_rates_posterior",
    "test_bootstrap.py::test_rell_prefers_true_topology",
    "test_codon.py::test_codon_mxu_kernel_variant_interpret",
    "test_distributed.py::test_two_process_sharded_plf",
    "test_empirical.py::test_empirical_protein_model_runs",
    "test_empirical.py::test_builtin_lg_likelihood_regression",
    "test_empirical.py::test_infer_cli_with_lg",
    "test_examples.py::test_example_runs[model_selection.py]",
    "test_fuzz.py::test_fuzz_backends_vs_golden",
    "test_grad.py::test_vjp_matches_autodiff[False]",
    "test_invariant.py::test_pinv_matches_oracle",
    "test_invariant.py::test_pinv_zero_weight_equals_plain_gamma",
    "test_models.py::test_protein_tree_likelihood",
    "test_optimize.py::test_fit_model_with_alpha",
    "test_optimize.py::test_fit_model_improves_likelihood",
    "test_optimize.py::test_optimize_increases_likelihood",
    "test_partition.py::test_partitioned_mixed_state_spaces",
    "test_partition.py::test_partitioned_optimize_improves",
    "test_partition.py::test_partitioned_joint_fn_matches_ll",
    "test_partition.py::test_partitioned_ll_is_sum_of_parts",
    "test_pipeline.py::",
    "test_search.py::test_newick_roundtrip_likelihood",
    "test_search.py::test_tree_search_checkpoint_resume",
    "test_search.py::test_nni_search_recovers_better_topology",
    "test_search.py::test_spr_search_improves",
    "test_sharding.py::test_sharded_protein",
    "test_support.py::test_alrt_on_ml_tree_is_nonnegative_and_supported",
    "test_support.py::test_annotate_alrt_labels",
    "test_tree_grad.py::test_tree_grads_match_xla_underflow",
    "test_tree_kernel.py::test_fused_deep_tree_scalers",
    "test_tree_kernel.py::test_sharded_tree_likelihood_matches_single_device",
    "test_tree_kernel.py::test_fused_matches_per_node_traversal",
)


def pytest_collection_modifyitems(config, items):
    for it in items:
        nid = it.nodeid.split("tests/")[-1]
        if any(nid.startswith(p) for p in SLOW_TESTS):
            it.add_marker(pytest.mark.slow)

# Exactness policy: the golden model (reference.py, the native oracle) is
# bit-exact to the scalar C reference.  The XLA paths and the Triton
# kernel let the compiler contract mul+add into FMA (on the CPU and the
# GPU alike), so they are held to a few ULP per CLV element: rtol 5e-7.


def assert_clv_match(got, ref, exact=False):
    got = np.asarray(got)
    ref = np.asarray(ref)
    assert got.shape == ref.shape
    if exact:
        np.testing.assert_array_equal(got, ref)
    else:
        np.testing.assert_allclose(got, ref, rtol=5e-7, atol=1e-37)


@pytest.fixture
def rng():
    return np.random.default_rng(1234)


@pytest.fixture
def gpu():
    """The first GPU device; skips the test where there is none.  The
    decision is made here, at run time — never while a module imports."""
    try:
        devices = jax.devices("gpu")
    except RuntimeError:
        devices = []
    if not devices:
        pytest.skip("needs an NVIDIA GPU (this backend has none)")
    return devices[0]


def bruteforce_loglik(pm, t_vec=None, rates=None, weights=None):
    """Float64 pruning log-likelihood of a PhyloModel at branch lengths
    ``t_vec`` (indexed by child node), category ``rates`` and mixture
    ``weights`` — an oracle independent of every device path, with the
    Lewis correction when the model carries one."""
    m = pm.model
    S = m.states
    rates = np.asarray(pm.rates if rates is None else rates, np.float64)
    weights = np.asarray(pm.rate_weights if weights is None else weights,
                         np.float64)
    C = len(rates)
    n = pm.n_sites
    if t_vec is None:
        t_vec = [pm.tree.nodes[i].length for i in range(pm.tree.n_nodes - 1)]
    from plf_tpu.io.alignment import AMBIGUITY
    amb = AMBIGUITY.get(S, ())
    partials = {}
    for leaf in range(pm.tree.n_leaves):
        si = pm.tip_states[leaf]
        onehot = np.zeros((n, S))
        ok = (si >= 0) & (si < S)
        onehot[np.arange(n)[ok], si[ok]] = 1.0
        for k, members in enumerate(amb):
            for mem in members:
                onehot[si == S + k, mem] = 1.0
        onehot[(si < 0) | (si >= S + len(amb))] = 1.0
        partials[leaf] = np.repeat(onehot[:, None, :], C, axis=1)
    for parent, lc, rc, _, _ in pm.schedule:
        out = np.empty((n, C, S))
        for c in range(C):
            p1 = m.p_matrix(float(t_vec[lc]), rates[c])
            p2 = m.p_matrix(float(t_vec[rc]), rates[c])
            out[:, c, :] = ((partials[lc][:, c, :] @ p1.T)
                            * (partials[rc][:, c, :] @ p2.T))
        partials[parent] = out
    lik = (partials[pm.tree.root] @ m.pi) @ weights
    ll = float(np.sum(np.log(lik) * pm.wgt))
    if pm.ascertainment == "lewis":
        p_const = float(np.sum(lik[pm.n_sites_obs:]))
        ll -= float(np.sum(pm.wgt)) * np.log1p(-p_const)
    return ll


def fd_grad(f, x, eps=1e-6):
    """Central finite differences of a float64 function of a vector."""
    x = np.asarray(x, np.float64)
    g = np.empty_like(x)
    for i in range(len(x)):
        xp, xm = x.copy(), x.copy()
        xp[i] += eps
        xm[i] -= eps
        g[i] = (f(xp) - f(xm)) / (2 * eps)
    return g


def make_random_case(rng, n, states=4, categories=4, underflow=True):
    """Random PLF inputs mirroring the reference's generator, including the
    forced-underflow pattern scale=1e-12^(j%64<16) (host_mem.cpp:179-209)."""
    S, C = states, categories
    e = S * C
    ev = rng.random((S, S), dtype=np.float32)
    left = rng.random((C, S, S), dtype=np.float32)
    right = rng.random((C, S, S), dtype=np.float32)
    x1 = rng.random((n * e,), dtype=np.float32)
    x2 = rng.random((n * e,), dtype=np.float32)
    if underflow:
        j = np.arange(n * e)
        x1 = np.where(j % (4 * e) < e, x1 * np.float32(1e-12), x1)
    wgt = np.ones((n,), dtype=np.int32)
    return (x1.reshape(n, C, S), x2.reshape(n, C, S), left, right, ev, wgt)


@pytest.fixture
def random_case_factory(rng):
    return lambda n, **kw: make_random_case(rng, n, **kw)
