"""Marginal ancestral state reconstruction (RAxML -f A parity).

Given a PhyloModel (tree + substitution model + alignment), compute for
every internal node the marginal posterior probability of each state at
each site:

    P(state_v = s | data) ∝ sum_c  down_vc(s) * up_vc(s)

where ``up`` is the usual conditional likelihood of the subtree below
``v`` (Felsenstein pruning — what the PLF computes) and ``down`` is the
complementary likelihood of everything outside that subtree, obtained by
a root-to-tips pass.  Gamma categories are integrated with their uniform
prior (the per-category factors appear in both passes and normalisation
handles the 1/C constants).

This runs in STATE space with explicit per-category P matrices — the
(n*C, S) @ (S, S) contractions are real matmuls, and the
whole two-pass computation jits into one dispatch.  Per-node per-site
max-normalisation keeps everything in fp32 range (posteriors are scale
invariant).

The reference accelerator computes only the up pass's inner kernel; the
down pass is new framework scope (the production feature RAxML layers on
the same kernel).
"""

from __future__ import annotations

from typing import Dict

import jax
import jax.numpy as jnp
import numpy as np

from .phylo import PhyloModel

__all__ = ["ancestral_marginal", "site_rates"]

_HI = None  # set lazily to jax.lax.Precision.HIGHEST


def _p_matrices(pm: PhyloModel):
    """(node -> (C, S, S) transition matrices P[c, from, to])."""
    out = {}
    for node in pm.tree.nodes:
        if node.index == pm.tree.root:
            continue
        out[node.index] = np.stack(
            [pm.model.p_matrix(node.length, r) for r in pm.rates]
        ).astype(np.float32)
    return out


def ancestral_marginal(pm: PhyloModel) -> Dict[int, np.ndarray]:
    """Posterior state probabilities at every internal node.

    Returns ``{node_index: (n_sites, S) float32}`` with rows summing to
    1 (sites are the observed sites; ascertainment dummy columns are
    excluded).  Leaf nodes are omitted (their states are the data).
    """
    global _HI
    if _HI is None:
        _HI = jax.lax.Precision.HIGHEST

    S = pm.model.states
    C = pm.config.categories
    n = pm.n_sites
    schedule = [(p, l, r) for (p, l, r, _, _) in pm.schedule]
    n_leaves = pm.tree.n_leaves
    root = pm.tree.root
    pmats = _p_matrices(pm)

    # one-/multi-hot tips in state space, (n, C, S); IUPAC partial
    # ambiguity -> member states, gaps = all-ones
    from ..io.alignment import AMBIGUITY
    amb = AMBIGUITY.get(S, ())
    tips = {}
    for leaf in range(n_leaves):
        si = pm.tip_states[leaf]
        onehot = np.zeros((n, S), np.float32)
        valid = (si >= 0) & (si < S)
        onehot[np.arange(n)[valid], si[valid]] = 1.0
        for k, members in enumerate(amb):
            for m in members:
                onehot[si == S + k, m] = 1.0
        onehot[(si < 0) | (si >= S + len(amb))] = 1.0
        tips[leaf] = jnp.asarray(
            np.repeat(onehot[:, None, :], C, axis=1))

    pdev = {k: jnp.asarray(v) for k, v in pmats.items()}
    pi = jnp.asarray(pm.model.pi.astype(np.float32))

    def norm(x):
        """Per-site max-normalisation (scale invariant downstream)."""
        m = jnp.max(x, axis=(1, 2), keepdims=True)
        return x / jnp.maximum(m, jnp.float32(1e-30))

    def msg_up(child_up, P):
        """Message child -> parent: (n,C,S_parent) = up . P^T per cat."""
        # einsum 'ncs,cus->ncu': sum over child state s
        return jnp.einsum("ncs,cus->ncu", child_up, P, precision=_HI)

    def run():
        up = dict(tips)
        msgs = {}
        for parent, l, r in schedule:
            ml = msg_up(up[l], pdev[l])
            mr = msg_up(up[r], pdev[r])
            msgs[l], msgs[r] = ml, mr
            up[parent] = norm(ml * mr)

        down = {root: jnp.broadcast_to(pi[None, None, :], (n, C, S))}
        posts = {}
        # parent-before-child order = reversed post-order
        for parent, l, r in reversed(schedule):
            base = down[parent]
            for v, sib_msg in ((l, msgs[r]), (r, msgs[l])):
                # outside-likelihood at v's parent, excluding v's subtree
                outer = base * sib_msg                      # (n, C, S_u)
                # push through v's branch: sum over parent state u
                down[v] = norm(jnp.einsum(
                    "ncu,cus->ncs", outer, pdev[v], precision=_HI))
            if parent >= n_leaves:
                # Integrate categories with their mixture weights
                # (uniform 1/C cancels in the normalisation; +I /
                # explicit rate_weights do not).
                joint = jnp.einsum(
                    "ncs,c->ns", down[parent] * up[parent],
                    jnp.asarray(pm.rate_weights, jnp.float32))
                posts[parent] = joint / jnp.sum(joint, axis=1,
                                                keepdims=True)
        return posts

    posts = jax.jit(run)()
    n_obs = pm.n_sites_obs
    return {k: np.asarray(v)[:n_obs] for k, v in posts.items()}


def site_rates(pm: PhyloModel):
    """Per-site posterior rates (RAxML per-site rate / CAT output).

    Returns ``(mean_rate, cat_posterior)``: the posterior-mean
    substitution rate per observed site,

        E[r | site] = sum_c w_c r_c L_c(site) / sum_c w_c L_c(site),

    and the (n_sites, C) per-category posterior.  The per-category site
    likelihoods come from the root CLV of the standard traversal
    (rescaling factors are shared across categories at a site, so they
    cancel in the ratio).
    """
    res = pm.log_likelihood(keep_root_clv=True, method="per-node")
    S, C = pm.config.states, pm.config.categories
    x_root = np.asarray(res.root_clv, np.float64)     # (S*C, n_pad) rows a*C+c
    n = pm.n_sites_obs
    rv = np.asarray(pm.model.root_vector, np.float64)  # (S,)
    # L_c(site) = sum_a rv[a] * x_root[a*C + c, site]
    lik_cs = np.einsum("a,acn->cn", rv,
                       x_root[:, :n].reshape(S, C, n))        # (C, n)
    w = np.asarray(pm.rate_weights, np.float64)[:, None]       # (C, 1)
    post = w * lik_cs                                          # (C, n)
    post = post / np.maximum(post.sum(axis=0, keepdims=True), 1e-300)
    mean_rate = np.asarray(pm.rates, np.float64) @ post        # (n,)
    return mean_rate, post.T.astype(np.float64)
