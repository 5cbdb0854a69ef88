"""Batch scoring with the schedule as data, bf16 CLV storage, codon
traversals, and big-tree schedule machinery.

``batch_log_likelihood`` runs every candidate's register-machine
schedule (ops/schedule.compile_register_schedule) in one XLA program
(ops/tree_xla.traverse_dynamic, vmapped over memory-sized chunks); each
candidate must score what its own single-model evaluation scores.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from plf_tpu.config import PLFConfig
from plf_tpu.models import PhyloModel, hky85, random_tree
from plf_tpu.models.optimize import tree_loglik_fn
from plf_tpu.models.phylo import batch_log_likelihood
from plf_tpu.models.search import nni_neighbors, spr_neighbors
from plf_tpu.ops.schedule import (compile_register_schedule,
                                  reorder_schedule, schedule_depth)


def _candidates(trees, tips, **cfg):
    cfg = PLFConfig(block_sites=128, **cfg)
    pm0 = PhyloModel(trees[0], hky85(2.0), tips, alpha=0.5, config=cfg)
    return [pm0] + [PhyloModel(t, pm0.model, tips, alpha=0.5, config=cfg,
                               share_device_from=pm0) for t in trees[1:]]


def _per_candidate(pms):
    return np.asarray([pm.log_likelihood(method="per-node").log_likelihood
                       for pm in pms])


def test_batch_log_likelihood_matches_per_candidate():
    n_leaves, n = 14, 300
    tips = np.random.default_rng(11).integers(0, 4, size=(n_leaves, n))
    base = random_tree(n_leaves, seed=11)
    pms = _candidates([base] + nni_neighbors(base)[:5], tips)
    got = batch_log_likelihood(pms)
    np.testing.assert_allclose(got, _per_candidate(pms), rtol=1e-6)
    assert len({round(v, 6) for v in got}) > 1   # candidates differ


def test_batch_spr_candidates_with_uneven_slot_counts():
    """Candidates whose register schedules need different slot counts
    share one program sized to the largest."""
    n_leaves, n = 14, 300
    tips = np.random.default_rng(21).integers(0, 4, size=(n_leaves, n))
    base = random_tree(n_leaves, seed=21)
    trees = [base] + spr_neighbors(base, max_neighbors=8, seed=1)
    pms = _candidates(trees, tips)
    slots = {compile_register_schedule(pm._sched_r, n_leaves)[1]
             for pm in pms}
    got = batch_log_likelihood(pms)
    assert np.all(np.isfinite(got))
    np.testing.assert_allclose(got, _per_candidate(pms), rtol=1e-6)
    assert len(slots) >= 1


@pytest.mark.parametrize("budget,chunk", [(1, 1), (3, 3), (None, 7)])
def test_batch_chunks_to_memory_budget(budget, chunk, monkeypatch):
    """The vmapped chunk follows the memory budget; a B that is not a
    chunk multiple pads with repeats that never reach the result."""
    from plf_tpu.models import phylo
    from plf_tpu.ops.tree_xla import batch_chunk

    n_leaves, n = 8, 200
    tips = np.random.default_rng(5).integers(0, 4, size=(n_leaves, n))
    base = random_tree(n_leaves, seed=5)
    pms = _candidates([base] + nni_neighbors(base)[:6], tips)
    _, n_slots, _ = compile_register_schedule(pms[0]._sched_r, n_leaves)
    per = (n_slots + 6) * 16 * pms[0].n_pad * 4
    if budget is not None:
        monkeypatch.setattr(phylo, "_batch_budget_bytes",
                            lambda: budget * per + 1)
    assert batch_chunk(len(pms), n_slots, 16, pms[0].n_pad,
                       phylo._batch_budget_bytes()) == chunk
    got = batch_log_likelihood(pms)
    assert got.shape == (len(pms),)
    np.testing.assert_allclose(got, _per_candidate(pms), rtol=1e-6)


def test_batch_rejects_mismatched_alignments():
    n_leaves, n = 6, 128
    rng = np.random.default_rng(2)
    t = random_tree(n_leaves, seed=2)
    cfg = PLFConfig(block_sites=128)
    a = PhyloModel(t, hky85(2.0), rng.integers(0, 4, (n_leaves, n)),
                   config=cfg)
    b = PhyloModel(t, a.model, rng.integers(0, 4, (n_leaves, n)),
                   config=cfg)
    with pytest.raises(ValueError, match="identical alignment"):
        batch_log_likelihood([a, b])


def test_reorder_schedule_pectinate_5000():
    # 5000-taxa caterpillar: a recursive reorder would exceed the
    # interpreter stack; the iterative one returns a depth-2 schedule
    n_leaves = 5000
    sched = []
    prev = 0
    nid = n_leaves
    for i in range(1, n_leaves):
        sched.append((nid, prev, i, 0.1, 0.1))
        prev = nid
        nid += 1
    out = reorder_schedule(sched, n_leaves)
    assert len(out) == len(sched)
    assert schedule_depth(out, n_leaves) <= 3
    _, n_slots, _ = compile_register_schedule(out, n_leaves)
    assert n_slots <= 3


def test_bf16_storage_close_and_distinct():
    """dtype='bfloat16' stores the intermediate CLVs in bf16: the ll
    stays within the bf16 error class of fp32 but is not identical
    (the rounding really happens)."""
    tree = random_tree(20, seed=2)
    tips = np.random.default_rng(3).integers(0, 4, size=(20, 512))
    r32 = PhyloModel(tree, hky85(2.0), tips, alpha=0.6,
                     config=PLFConfig(block_sites=128)).log_likelihood()
    r16 = PhyloModel(tree, hky85(2.0), tips, alpha=0.6,
                     config=PLFConfig(block_sites=128, dtype="bfloat16")
                     ).log_likelihood()
    rel = abs(r16.log_likelihood - r32.log_likelihood) / abs(
        r32.log_likelihood)
    assert rel < 5e-3, rel
    assert r16.log_likelihood != r32.log_likelihood


def test_bf16_storage_gradients_close():
    tree = random_tree(12, seed=5)
    tips = np.random.default_rng(5).integers(0, 4, size=(12, 512))
    fns = [tree_loglik_fn(PhyloModel(tree, hky85(2.0), tips, alpha=0.6,
                                     config=PLFConfig(block_sites=128,
                                                      dtype=dt)))
           for dt in ("float32", "bfloat16")]
    t0 = jnp.asarray(fns[0][1])
    (v32, g32), (v16, g16) = [jax.value_and_grad(f)(t0) for f, _ in fns]
    assert abs(float(v16) - float(v32)) / abs(float(v32)) < 5e-3
    rel = float(jnp.max(jnp.abs(g16 - g32) / (jnp.abs(g32) + 1e-2)))
    assert rel < 0.05, rel


def test_codon_traversal_and_gradient():
    """S=61 (244 rows) through the dot form: the XLA traversal against
    the float64 brute force, and its gradient against finite
    differences of that oracle.  GY94 eigenvectors are ill-conditioned
    (mixed-sign eigen-coordinate CLVs cancel), so fp32 holds the total
    to ~1e-5 relative, not to the DNA bound."""
    from plf_tpu.models import codon_gy94
    from tests.conftest import bruteforce_loglik, fd_grad

    tree = random_tree(5, seed=7, mean_branch=0.2)
    tips = np.random.default_rng(3).integers(0, 61, size=(5, 128))
    cfg = PLFConfig(states=61, block_sites=128, kernel_variant="mxu")
    pm = PhyloModel(tree, codon_gy94(2.0, 0.3), tips, alpha=0.7,
                    config=cfg)
    ll = pm.log_likelihood().log_likelihood
    assert ll == pytest.approx(pm.log_likelihood_bruteforce(), rel=5e-5)
    fn, t0 = tree_loglik_fn(pm)
    g = np.asarray(jax.grad(fn)(jnp.asarray(t0)))
    want = fd_grad(lambda t: bruteforce_loglik(pm, t), t0)
    np.testing.assert_allclose(g, want, rtol=5e-3, atol=5e-2)
