"""NNI tree search tests."""

import numpy as np
import pytest

from plf_tpu.config import PLFConfig
from plf_tpu.models import (PhyloModel, hky85, nni_neighbors, nni_search,
                            parse_newick, random_tree, simulate_alignment)


def test_nni_neighbors_valid_trees():
    tree = random_tree(6, seed=1)
    neigh = nni_neighbors(tree)
    assert len(neigh) > 0
    for t in neigh:
        assert t.n_leaves == 6
        sched = t.schedule()
        assert len(sched) == 5
        # all leaves reachable exactly once
        seen = []
        for p, l, r, _, _ in sched:
            for c in (l, r):
                if c < 6:
                    seen.append(c)
        assert sorted(seen) == list(range(6))


def test_nni_neighbors_differ_from_original():
    tree = parse_newick("((A:0.1,B:0.1):0.1,(C:0.1,D:0.1):0.1);")
    neigh = nni_neighbors(tree)
    orig = {tuple(n.children) for n in tree.nodes if n.children}
    assert any({tuple(n.children) for n in t.nodes if n.children} != orig
               for t in neigh)


def test_nni_search_recovers_better_topology():
    """Start from a deliberately scrambled topology on simulated data;
    NNI search must improve the likelihood."""
    true_tree = random_tree(6, seed=7, mean_branch=0.2)
    model = hky85(2.0, [0.3, 0.2, 0.3, 0.2])
    tips = simulate_alignment(true_tree, model, 500, seed=2)
    cfg = PLFConfig(block_sites=128, interpret=True)
    # scrambled start: a caterpillar over the same leaves
    nwk = "t0:0.1"
    for i in range(1, 6):
        nwk = f"({nwk},t{i}:0.1):0.1"
    start = parse_newick(nwk + ";")
    ll_start = PhyloModel(start, model, tips,
                          config=cfg).log_likelihood().log_likelihood
    res = nni_search(start, model, tips, config=cfg, max_rounds=3)
    assert res.log_likelihood >= ll_start
    assert res.evaluations > 1


# ---------------------------------------------------------------------------
# SPR + unified search driver
# ---------------------------------------------------------------------------

from plf_tpu.models import spr_neighbors, spr_search, tree_search


def _leaf_multiset(t):
    seen = []
    for p, l, r, _, _ in t.schedule():
        for c in (l, r):
            if c < t.n_leaves:
                seen.append(c)
    return sorted(seen)


def test_spr_neighbors_valid_trees():
    tree = random_tree(7, seed=3)
    neigh = spr_neighbors(tree)
    assert len(neigh) > len(nni_neighbors(tree))  # SPR superset in size
    for t in neigh:
        assert t.n_leaves == 7
        sched = t.schedule()
        assert len(sched) == 6          # still binary, same node count
        assert _leaf_multiset(t) == list(range(7))


def test_spr_neighbors_preserve_total_length():
    tree = random_tree(6, seed=5)
    total = sum(n.length for n in tree.nodes)
    for t in spr_neighbors(tree):
        assert np.isclose(sum(n.length for n in t.nodes), total, rtol=1e-6)


def test_spr_subsample():
    tree = random_tree(8, seed=2)
    full = spr_neighbors(tree)
    sub = spr_neighbors(tree, max_neighbors=5, seed=1)
    assert len(sub) == 5 < len(full)


def test_newick_roundtrip_likelihood():
    """to_newick -> parse_newick preserves the likelihood (leaf rows
    re-matched by name)."""
    from plf_tpu.models import PhyloModel
    tree = random_tree(6, seed=11, mean_branch=0.15)
    model = hky85(1.7, [0.28, 0.22, 0.26, 0.24])
    tips = simulate_alignment(tree, model, 300, seed=4)
    cfg = PLFConfig(block_sites=128, interpret=True)
    ll0 = PhyloModel(tree, model, tips, config=cfg
                     ).log_likelihood().log_likelihood
    t2 = parse_newick(tree.to_newick())
    name_to_row = {(n.name or f"t{n.index}"): n.index
                   for n in tree.nodes if n.is_leaf}
    perm = [name_to_row[nm] for nm in t2.leaf_names()]
    ll1 = PhyloModel(t2, model, tips[perm], config=cfg
                     ).log_likelihood().log_likelihood
    assert np.isclose(ll0, ll1, rtol=1e-6)


def test_spr_round_scores_in_one_batched_dispatch(monkeypatch):
    # SPR neighbourhoods are same-(E, n_slots) shape classes and must
    # ride the batched register-machine kernel: one
    # batch_log_likelihood call per round, never per candidate
    import plf_tpu.models.phylo as phylo_mod
    from plf_tpu.models.search import spr_search

    calls = {"batch": 0, "sizes": []}
    orig = phylo_mod.batch_log_likelihood

    def counting(pms):
        calls["batch"] += 1
        calls["sizes"].append(len(pms))
        return orig(pms)

    monkeypatch.setattr(phylo_mod, "batch_log_likelihood", counting)
    tree = random_tree(8, seed=3)
    tips = np.random.default_rng(3).integers(0, 4, size=(8, 96))
    spr_search(tree, hky85(2.0), tips, alpha=0.5,
               config=PLFConfig(block_sites=128), max_rounds=1,
               max_neighbors=10)
    assert calls["batch"] == 1
    # 10 candidates + the incumbent scored in the same batch (the
    # epsilon-free same-scorer comparison)
    assert calls["sizes"][0] == 11


def test_spr_search_improves():
    true_tree = random_tree(6, seed=9, mean_branch=0.2)
    model = hky85(2.0)
    tips = simulate_alignment(true_tree, model, 256, seed=6)
    cfg = PLFConfig(block_sites=128, interpret=True)
    nwk = "t0:0.1"
    for i in range(1, 6):
        nwk = f"({nwk},t{i}:0.1):0.1"
    start = parse_newick(nwk + ";")
    from plf_tpu.models import PhyloModel
    ll_start = PhyloModel(start, model, tips,
                          config=cfg).log_likelihood().log_likelihood
    res = spr_search(start, model, tips, config=cfg, max_rounds=1,
                     max_neighbors=12)
    assert res.log_likelihood >= ll_start
    assert res.evaluations > 1


def test_tree_search_checkpoint_resume(tmp_path):
    """A checkpointed search resumed from round k reaches the same tree
    as an uninterrupted run."""
    true_tree = random_tree(5, seed=13, mean_branch=0.25)
    model = hky85(2.0)
    tips = simulate_alignment(true_tree, model, 300, seed=8)
    cfg = PLFConfig(block_sites=128, interpret=True)
    nwk = "t0:0.1"
    for i in range(1, 5):
        nwk = f"({nwk},t{i}:0.1):0.1"
    start = parse_newick(nwk + ";")

    full = tree_search(start, model, tips, config=cfg, strategy="nni",
                       max_rounds=4)

    ckpt = str(tmp_path / "search.npz")
    tree_search(start, model, tips, config=cfg, strategy="nni",
                max_rounds=1, checkpoint_path=ckpt)   # interrupted run
    resumed = tree_search(start, model, tips, config=cfg, strategy="nni",
                          max_rounds=4, checkpoint_path=ckpt)
    assert np.isclose(resumed.log_likelihood, full.log_likelihood,
                      rtol=1e-9)
    assert resumed.accepted_moves == full.accepted_moves


def test_batch_scoring_large_taxa_single_program():
    """Neighbourhoods of many taxa score in one batched program (the
    slot arena lives in device memory, so no taxon count is too big for
    it) and match per-candidate evaluation."""
    from plf_tpu.models.phylo import PhyloModel, batch_log_likelihood
    from plf_tpu.models.search import nni_neighbors

    n_taxa = 300
    tree = random_tree(n_taxa, seed=1)
    tips = np.random.default_rng(2).integers(
        0, 4, size=(n_taxa, 128)).astype(np.int32)
    cfg = PLFConfig(block_sites=128)
    pms = [PhyloModel(t, hky85(2.0), tips, alpha=0.5, config=cfg)
           for t in nni_neighbors(tree)[:2]]
    got = batch_log_likelihood(pms)
    want = [pm.log_likelihood_bruteforce() for pm in pms]
    np.testing.assert_allclose(got, want, rtol=1e-5)


@pytest.mark.slow
def test_refined_search_beats_fixed_length_search():
    """Lazy-SPR-grade refinement: with move-touched branch lengths
    re-scored at scaled variants (refine_top), the search reaches a
    strictly higher ll than fixed-length search in the same number of
    rounds on a distorted start (moves whose improvement only shows
    after local length adjustment are recovered)."""
    from plf_tpu.models.search import nni_search
    from plf_tpu.models.tree import Tree, TreeNode

    true_tree = random_tree(16, seed=1, mean_branch=0.15)
    model = hky85(4.0)
    tips = simulate_alignment(true_tree, model, 600, alpha=0.7, seed=1)
    start = random_tree(16, seed=51, mean_branch=0.15)
    nodes = [TreeNode(n.index, n.name, n.length * 6.0, n.children)
             for n in start.nodes]
    start = Tree(nodes=nodes, root=start.root)
    cfg = PLFConfig(block_sites=128)
    r0 = nni_search(start, model, tips, alpha=0.7, config=cfg,
                    max_rounds=6)
    r1 = nni_search(start, model, tips, alpha=0.7, config=cfg,
                    max_rounds=6, refine_top=4)
    assert r1.log_likelihood > r0.log_likelihood + 10.0


def test_refinement_variants_include_identity_margin():
    """The refinement pass never degrades a round: variants are only
    accepted when they beat BOTH the incumbent and the best unrefined
    candidate margin (same-batch comparisons)."""
    from plf_tpu.models.search import (_scaled_lengths, nni_neighbors,
                                       spr_neighbors)

    tree = random_tree(8, seed=3)
    trees, moves = nni_neighbors(tree, with_moves=True)
    assert len(trees) == len(moves)
    assert all(len(m) == 3 for m in moves)
    t2 = _scaled_lengths(trees[0], moves[0], 2.0)
    for node in moves[0]:
        assert np.isclose(t2.nodes[node].length,
                          trees[0].nodes[node].length * 2.0)
    trees_s, moves_s = spr_neighbors(tree, with_moves=True,
                                     max_neighbors=7, seed=1)
    assert len(trees_s) == len(moves_s) == 7
    assert all(len(m) == 4 for m in moves_s)
