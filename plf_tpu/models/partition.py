"""Partitioned models: per-partition Q matrix / alpha on a shared tree.

Production phylogenetics splits an alignment into partitions (genes,
codon positions) that share the tree topology and branch lengths but get
their own substitution model, gamma shape, and optionally a per-partition
branch-length multiplier ("proportional branch lengths", RAxML's -q/-M).
The reference accelerator computes one PLF at a time and leaves this to
the host application; here it is a first-class driver on top of
:class:`PhyloModel`.

Total log-likelihood is the sum over partitions (sites are independent),
so evaluation is embarrassingly parallel across partitions AND sites —
each partition's traversal is one dispatch, and the per-partition
likelihoods combine on host (or under one jit in the differentiable
joint-fit path).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import numpy as np

from ..config import PLFConfig
from .phylo import PhyloModel, TreeLikelihoodResult
from .substitution import SubstitutionModel
from .tree import Tree

__all__ = ["Partition", "PartitionedModel", "PartitionedResult"]


@dataclasses.dataclass
class Partition:
    """One alignment partition.

    ``sites``: column indices into the alignment (any order, disjointness
    is the caller's contract).  ``scale``: initial branch-length
    multiplier for proportional-branch-length fitting.
    """

    name: str
    sites: np.ndarray
    model: SubstitutionModel
    alpha: Optional[float] = None
    wgt: Optional[np.ndarray] = None
    scale: float = 1.0


@dataclasses.dataclass
class PartitionedResult:
    log_likelihood: float
    per_partition: List[TreeLikelihoodResult]


class PartitionedModel:
    """Shared-tree, per-partition-model likelihood + joint fitting."""

    def __init__(self, tree: Tree, partitions: Sequence[Partition],
                 tip_states: np.ndarray,
                 config: Optional[PLFConfig] = None,
                 ascertainment: Optional[str] = None):
        tip_states = np.asarray(tip_states)
        self.tree = tree
        self.partitions = list(partitions)
        self.models: List[PhyloModel] = []
        for p in self.partitions:
            cfg = config
            if cfg is not None and cfg.states != p.model.states:
                cfg = dataclasses.replace(cfg, states=p.model.states)
            self.models.append(PhyloModel(
                tree, p.model, tip_states[:, np.asarray(p.sites)],
                wgt=p.wgt, alpha=p.alpha, config=cfg,
                ascertainment=ascertainment))

    def log_likelihood(self, method: str = "auto") -> PartitionedResult:
        results = [pm.log_likelihood(method=method) for pm in self.models]
        return PartitionedResult(
            log_likelihood=float(sum(r.log_likelihood for r in results)),
            per_partition=results)

    def log_likelihood_sharded(self, mesh=None) -> PartitionedResult:
        """Partitioned likelihood with every partition's site axis
        sharded over the device mesh: each partition runs the sharded
        traversal (PhyloModel.log_likelihood_sharded — one psum
        per partition), totals sum on host.  Partitions are independent
        site ranges, so this is the full data-parallel evaluation of a
        production partitioned analysis (beyond-reference scope the
        reference README wishes for, /root/reference/README.md:201-205).
        """
        results = [pm.log_likelihood_sharded(mesh=mesh)
                   for pm in self.models]
        return PartitionedResult(
            log_likelihood=float(sum(r.log_likelihood for r in results)),
            per_partition=results)

    # -- differentiable joint objective --------------------------------------

    def loglik_fn(self, proportional: bool = True, mesh=None):
        """Joint jittable objective over shared branch lengths.

        Returns ``(fn, t0, scales0)`` with
        ``fn(t_vec, log_scales) = sum_p ll_p(t_vec * exp(log_scales[p]))``.
        ``log_scales[0]`` should be held at 0 by the caller when fitting
        (only ratios are identifiable alongside free branch lengths);
        with ``proportional=False`` scales are ignored entirely.

        With ``mesh`` each partition's likelihood (forward AND backward)
        runs site-sharded under shard_map — the joint fit differentiates
        a fully distributed objective.
        """
        import jax
        import jax.numpy as jnp

        from .optimize import tree_loglik_fn

        fns = []
        t0 = None
        for pm in self.models:
            fn, t0_p = tree_loglik_fn(pm, with_rates=True, mesh=mesh)
            fns.append((fn, jnp.asarray(pm.rates, jnp.float32)))
            t0 = t0_p if t0 is None else t0

        scales0 = np.array([p.scale for p in self.partitions], np.float32)

        def joint(t_vec, log_scales):
            total = jnp.float32(0.0)
            for i, (fn, rates) in enumerate(fns):
                s = jnp.exp(log_scales[i]) if proportional else 1.0
                total = total + fn(t_vec * s, rates)
            return total

        return jax.jit(joint), t0, scales0

    def optimize(self, steps: int = 100, learning_rate: float = 0.02,
                 min_length: float = 1e-6, proportional: bool = True,
                 mesh=None):
        """Jointly fit shared branch lengths (+ per-partition multipliers).

        Returns ``(t_opt, scales_opt, ll_before, ll_after)``; the first
        partition's multiplier is pinned to 1 for identifiability.
        """
        import jax
        import jax.numpy as jnp
        import optax

        fn, t0, scales0 = self.loglik_fn(proportional=proportional,
                                         mesh=mesh)
        P = len(self.partitions)
        params0 = {
            "log_t": jnp.log(jnp.maximum(jnp.asarray(t0), min_length)),
            "log_s": jnp.asarray(np.log(np.maximum(scales0, 1e-3))),
        }

        def pinned(log_s):
            return log_s - log_s[0]  # partition 0 multiplier == 1

        def loss(params):
            t = jnp.exp(params["log_t"]) + min_length
            return -fn(t, pinned(params["log_s"]))

        ll0 = -float(loss(params0))
        opt = optax.adam(learning_rate)
        state = opt.init(params0)

        @jax.jit
        def step(params, state):
            val, g = jax.value_and_grad(loss)(params)
            updates, state = opt.update(g, state)
            return optax.apply_updates(params, updates), state, val

        params = params0
        for _ in range(steps):
            params, state, _ = step(params, state)
        ll1 = -float(loss(params))
        t_opt = np.asarray(jnp.exp(params["log_t"]) + min_length)
        scales_opt = np.asarray(jnp.exp(pinned(params["log_s"])))
        return t_opt, scales_opt, ll0, ll1
