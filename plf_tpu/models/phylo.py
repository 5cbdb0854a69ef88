"""Whole-tree likelihood evaluation: the production driver around the PLF.

The entire post-order traversal — every internal node's PLF, the
underflow-scaler accumulation and the root reduction — compiles into
ONE device program per (tree, site-count) shape.  It corresponds to the
RAxML context the reference accelerator plugs into (one
``newviewGAMMA`` per internal node per evaluation; the reference
benchmarks ``plf_calls`` repetitions of a single node,
host_mem.cpp:283-394, and pays PCIe per call — README.md:204 names that
its main bottleneck; here CLVs never leave device memory).

Two paths compute it (``log_likelihood(method=...)``):

* ``"per-node"`` — the XLA traversal (ops/tree_xla.traverse): one fused
  node op per internal node, intermediate CLVs in device memory.  Every
  model, every backend.
* ``"fused"`` — the whole-tree Triton kernel (ops/tree_triton.py): the
  traversal of a site block runs in one program, its live CLVs in an
  L2-resident slot arena.  DNA-sized models at the "vpu" variant; GPU,
  or the Pallas interpreter when ``config.interpret``.

``"auto"`` takes the kernel on a GPU backend where it covers the case,
and the XLA traversal otherwise.  The result says which path ran.

Tips are held as int8/int32 state codes and expanded to eigen-coordinate
CLVs on device inside the traversal, so host->device traffic is 1
byte/site/leaf instead of 64.

Log-likelihood:  ll = sum_s wgt_s * log( sum_c w_c rv . x_root[s,c,:] )
                     + scaler_total * log(2^-32)

with ``rv = pi^T U`` (eigen->likelihood root vector), ``w_c`` the
category weights, and ``scaler_total`` the wgt-weighted count of all
rescales in the tree (each multiplied a site CLV by 2^32; folded back
exactly as RAxML does).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..config import Backend, PLFConfig
from ..ops import layout as L
from ..ops import tree_triton
from ..ops.schedule import compile_register_schedule, reorder_schedule
from ..ops.tree_xla import LIK_FLOOR, LOG_MINLIK, batch_chunk, traverse
from .substitution import SubstitutionModel, branch_matrices
from .tree import Tree

__all__ = ["PhyloModel", "TreeLikelihoodResult", "batch_log_likelihood",
           "LIK_FLOOR", "LOG_MINLIK"]

METHODS = ("auto", "fused", "per-node")


@dataclasses.dataclass
class TreeLikelihoodResult:
    log_likelihood: float
    site_log_likelihood: np.ndarray   # (n_sites,) float64, pre-weighting
    scaler_total: int                 # wgt-weighted rescale count
    root_clv: Optional[jax.Array] = None  # lane-major root CLV (if kept)
    scaler_sites: Optional[np.ndarray] = None  # (n_sites,) per-site counts
    method: str = "per-node"          # the path that ran: fused / per-node

    def true_site_log_likelihood(self) -> np.ndarray:
        """Per-site log-likelihood with 2^-32 rescale factors folded in
        (what bootstrap/RELL resampling must weight)."""
        if self.scaler_sites is None:
            return self.site_log_likelihood
        return self.site_log_likelihood + self.scaler_sites * LOG_MINLIK


class PhyloModel:
    """Tree + substitution model + alignment -> log-likelihood on device.

    Example::

        model = PhyloModel(tree, hky85(2.0), tip_states, alpha=0.5)
        out = model.log_likelihood()
    """

    def __init__(self, tree: Tree, model: SubstitutionModel,
                 tip_states: np.ndarray, wgt: Optional[np.ndarray] = None,
                 alpha: Optional[float] = None,
                 config: Optional[PLFConfig] = None,
                 ascertainment: Optional[str] = None,
                 p_inv: Optional[float] = None,
                 rate_weights: Optional[np.ndarray] = None,
                 share_device_from: Optional["PhyloModel"] = None):
        """
        Args:
          tip_states: (n_leaves, n_sites) int array of observed states per
            leaf (leaf order = tree node indices 0..n_leaves-1);
            out-of-range/negative values = gap/ambiguous.
          wgt: (n_sites,) site pattern weights (RAxML wgt, plf.cpp:63).
          alpha: gamma shape; None = uniform rates.
          ascertainment: None or "lewis" — Lewis (2001) correction for
            variable-sites-only alignments: the likelihood conditions on
            the site being variable, ll_s -= log(1 - p_const) with
            p_const the summed probability of the S constant site
            patterns.  Implemented by appending S zero-weight constant
            dummy sites to the alignment; every evaluation path (fused,
            per-node, sharded, and the differentiable optimisers) applies
            the correction from their likelihoods.
          p_inv: proportion of invariant sites (+I / +I+G): adds a rate-0
            category with weight ``p_inv`` and rescales the gamma rates
            by 1/(1-p_inv) (substitution.gamma_invariant_rates).  The
            effective category count becomes ``config.categories + 1``.
          rate_weights: explicit per-category mixture weights (must sum
            to 1); default uniform 1/C.  Mutually exclusive with p_inv.
          share_device_from: another PhyloModel over the SAME alignment,
            substitution model and config (different topology/lengths):
            reuse its device-resident tip codes / weights / tip table /
            eigenvectors instead of re-uploading them.  Tree-search
            neighbourhoods build hundreds of same-alignment models per
            round — without sharing, every candidate re-uploads the
            (n_leaves, n_pad) codes matrix.
        """
        self.tree = tree
        self.model = model
        # default config resolves the kernel variant by state count
        cfg = config or PLFConfig(states=model.states,
                                  kernel_variant="auto")
        if cfg.states != model.states:
            cfg = dataclasses.replace(cfg, states=model.states)
        self.config = cfg
        self.tip_states = np.asarray(tip_states)
        self.n_sites_obs = int(self.tip_states.shape[1])
        self.wgt = (np.ones(self.n_sites_obs, np.int32) if wgt is None
                    else np.asarray(wgt, np.int32))
        if ascertainment not in (None, "lewis"):
            raise ValueError(f"unknown ascertainment {ascertainment!r}")
        self.ascertainment = ascertainment
        if ascertainment == "lewis":
            S_ = model.states
            const = np.tile(np.arange(S_, dtype=self.tip_states.dtype),
                            (self.tip_states.shape[0], 1))
            self.tip_states = np.concatenate([self.tip_states, const],
                                             axis=1)
            self.wgt = np.concatenate([self.wgt, np.zeros(S_, np.int32)])
        self.n_sites = int(self.tip_states.shape[1])
        self.p_inv = p_inv
        if p_inv is not None:
            if rate_weights is not None:
                raise ValueError("pass either p_inv or rate_weights")
            from .substitution import gamma_invariant_rates
            self.rates, self.rate_weights = gamma_invariant_rates(
                alpha, p_inv, cfg.categories)
            cfg = dataclasses.replace(cfg,
                                      categories=cfg.categories + 1)
            self.config = cfg
        else:
            if alpha is None:
                self.rates = np.ones(cfg.categories)
            else:
                from .substitution import discrete_gamma_rates
                self.rates = discrete_gamma_rates(alpha, cfg.categories)
            if rate_weights is None:
                self.rate_weights = np.full(cfg.categories,
                                            1.0 / cfg.categories)
            else:
                self.rate_weights = np.asarray(rate_weights, np.float64)
                if self.rate_weights.shape != (cfg.categories,):
                    raise ValueError(
                        f"rate_weights must have shape ({cfg.categories},)")
                if abs(float(self.rate_weights.sum()) - 1.0) > 1e-6:
                    raise ValueError("rate_weights must sum to 1")

        S, C = cfg.states, cfg.categories
        self.n_pad = L.sites_padding(self.n_sites, cfg.block_sites)
        self.schedule = tree.schedule()
        # Evaluation order: taller child first (few live CLVs).  Every
        # operator stack below is in this order.
        self._sched_r = reorder_schedule(self.schedule, tree.n_leaves)

        donor = share_device_from
        if donor is not None and (
                donor.model is not model
                or not np.array_equal(donor.rates, self.rates)
                or donor.config != self.config):
            raise ValueError(
                "share_device_from needs an identical model/rates/"
                "config (only topology/branch lengths may differ)")
        # Branch-matrix cache, shared across same-model/rates candidates
        # via share_device_from: a tree-search round builds hundreds of
        # same-alignment models whose branch-length MULTISET barely
        # changes (NNI preserves it; SPR halves one), and the per-edge
        # eigen-expm dominates candidate construction.
        self._branch_cache = ({} if donor is None
                              else donor._branch_cache)

        def branch(t):
            key = float(t)
            v = self._branch_cache.get(key)
            if v is None:
                v = np.asarray(branch_matrices(model, key, self.rates, C),
                               np.float32)
                self._branch_cache[key] = v
            return v

        # Host-side (E, C, S, S) stacks; the device upload is lazy (the
        # batch scorer stacks many candidates on host and uploads once).
        self._lops_np = np.stack([branch(e[3]) for e in self._sched_r])
        self._rops_np = np.stack([branch(e[4]) for e in self._sched_r])
        self._ops_dev = None
        # Root reduction: pi^T U weighted by the category mixture
        # (uniform 1/C unless +I or explicit rate_weights), as (S, C).
        rows = np.outer(model.root_vector, self.rate_weights)
        self._root_rows = jnp.asarray(rows.astype(np.float32))
        if donor is not None:
            same_aln = (donor.tip_states is self.tip_states
                        or (donor.tip_states.shape
                            == self.tip_states.shape
                            and np.array_equal(donor.tip_states,
                                               self.tip_states)))
            same_wgt = (donor.wgt is self.wgt
                        or np.array_equal(donor.wgt, self.wgt))
            if donor.n_pad != self.n_pad or not same_aln or not same_wgt:
                raise ValueError(
                    "share_device_from needs an identical alignment and"
                    " site weights (only topology/branch lengths may "
                    "differ)")
            self._codes = donor._codes
            self._wgt_dev = donor._wgt_dev
            self._ev = donor._ev
            self._tip_table = donor._tip_table
            self._tip_ncols = donor._tip_ncols
        else:
            from ..io.alignment import map_tip_codes, tip_expansion_table
            codes = map_tip_codes(self.tip_states, S)
            # Trim the tip table to the observed code range: the kernel
            # expands a tip with one select per column, and IUPAC
            # ambiguity columns are dead weight for the common
            # no-ambiguity alignment.  Gap code S is always present
            # (padding sites use it).
            self._tip_ncols = max(S + 1, int(codes.max()) + 1)
            tbl = tip_expansion_table(model.w, S)[:, :self._tip_ncols]
            self._tip_table = jnp.asarray(tbl.astype(np.float32))
            self._ev = jnp.asarray(np.asarray(model.plf_ev, np.float32))
            codes = L.pad_to_multiple(codes, self.n_pad, axis=-1)
            codes[:, self.n_sites:] = S
            if cfg.tip_dtype == "int8":
                codes = codes.astype(np.int8)
            self._codes = jnp.asarray(codes)      # (n_leaves, n_pad)
            wpad = L.pad_to_multiple(self.wgt.reshape(1, -1), self.n_pad,
                                     axis=-1)
            self._wgt_dev = jnp.asarray(wpad[0])  # (n_pad,) padding zeros
        self._jitted: Dict[str, object] = {}

    @property
    def _ops(self):
        """Device-resident (lops, rops), each (E, C, S, S) (lazy)."""
        if self._ops_dev is None:
            self._ops_dev = (jnp.asarray(self._lops_np),
                             jnp.asarray(self._rops_np))
        return self._ops_dev

    # -- path choice ---------------------------------------------------------

    def kernel_covers(self) -> bool:
        """Whether the whole-tree kernel handles this model and tree."""
        cfg = self.config
        return (cfg.backend is not Backend.XLA
                and tree_triton.covers(cfg.states, cfg.categories,
                                       cfg.resolved_kernel_variant))

    def resolve_method(self, method: str = "auto",
                       keep_root_clv: bool = False) -> str:
        """The path ``log_likelihood(method)`` runs: "fused" or
        "per-node".  "auto" takes the kernel only on a GPU backend."""
        if method not in METHODS:
            raise ValueError(f"unknown method {method!r}; one of {METHODS}")
        if method == "auto":
            use = (not keep_root_clv and self.kernel_covers()
                   and jax.default_backend() == "gpu")
            return "fused" if use else "per-node"
        if method == "fused":
            if keep_root_clv:
                raise ValueError("the fused kernel keeps no root CLV; use "
                                 "method='per-node'")
            if not self.kernel_covers():
                raise ValueError(
                    "the whole-tree kernel covers DNA-sized models "
                    f"(S <= {tree_triton.MAX_STATES}, S*C <= "
                    f"{tree_triton.MAX_ROWS}) at kernel_variant 'vpu'; "
                    "use method='per-node'")
        return method

    def site_lik_fn(self, method: str, keep_root: bool = False):
        """Pure ``(codes, lops, rops, n) -> (lik, scaler[, root CLV])`` of
        a path (``"fused"`` or ``"per-node"``), with ``n_pad`` from the
        codes; the sharded evaluation runs it per shard.  Only the
        traversal keeps the lane-major root CLV."""
        cfg = self.config
        ev, ttab, rr = self._ev, self._tip_table, self._root_rows
        if method == "fused":
            def fused(codes, lops, rops, n):
                ops = jnp.stack([lops, rops], axis=1)
                return tree_triton.plf_tree_triton(
                    codes, self._sched_r, ops, ev, ttab, rr, n,
                    interpret=cfg.interpret)
            return fused
        sched = tuple((p, l, r) for (p, l, r, *_x) in self._sched_r)

        def per_node(codes, lops, rops, n):
            lik, sc, x_root = traverse(
                codes, lops, rops, ev, ttab, rr, n, schedule=sched,
                n_leaves=self.tree.n_leaves,
                variant=cfg.resolved_kernel_variant,
                dtype=jnp.dtype(cfg.dtype))
            if keep_root:
                return lik, sc, x_root.reshape(cfg.rows, -1)
            return lik, sc
        return per_node

    def _run(self, method: str, keep_root_clv: bool):
        key = (method, keep_root_clv)
        if key not in self._jitted:
            self._jitted[key] = jax.jit(
                self.site_lik_fn(method, keep_root=keep_root_clv))
        return self._jitted[key](self._codes, *self._ops,
                                 jnp.int32(self.n_sites))

    # -- ascertainment correction ------------------------------------------

    def _asc_log_one_minus_pconst(self, lik_pad: np.ndarray,
                                  sc_sites: np.ndarray) -> float:
        """log(1 - p_const) from the S dummy constant-site likelihoods.

        ``lik_pad``/``sc_sites``: padded per-site likelihood and rescale
        counts; dummy sites occupy [n_sites_obs, n_sites).  True site
        probability = lik * 2^(-32*count), assembled in log space.
        """
        d0, d1 = self.n_sites_obs, self.n_sites
        log_pc = (np.log(np.asarray(lik_pad[d0:d1], np.float64))
                  + np.asarray(sc_sites[d0:d1], np.float64) * LOG_MINLIK)
        p_const = float(np.exp(log_pc).sum())
        if p_const >= 1.0:
            raise FloatingPointError(
                f"ascertainment correction degenerate: p_const={p_const}")
        return float(np.log1p(-p_const))

    def _finalise_ll(self, lik_pad: np.ndarray, sc_sites, scaler_total: int
                     ) -> TreeLikelihoodResult:
        """Host-side fp64 log/sum + optional ascertainment correction."""
        n_obs = self.n_sites_obs
        lik_h = np.asarray(lik_pad, dtype=np.float64)
        # Floor before the log, matching the differentiable paths
        # (optimize.py clamps at LIK_FLOOR): exact variants always produce
        # positive likelihoods so this is a no-op there, but the 1-pass
        # bf16 fast mode (kernel_variant="mxu_bf16") can round
        # near-underflow site likelihoods NEGATIVE — those sites get the
        # deterministic floor penalty instead of log(<0)=NaN.
        site_ll = np.log(np.maximum(lik_h[:n_obs], LIK_FLOOR))
        corr = 0.0
        if self.ascertainment == "lewis":
            corr = self._asc_log_one_minus_pconst(lik_h, sc_sites)
            site_ll = site_ll - corr
        ll = float(np.sum(site_ll * self.wgt[:n_obs])
                   + scaler_total * LOG_MINLIK)
        return TreeLikelihoodResult(
            log_likelihood=ll, site_log_likelihood=site_ll,
            scaler_total=int(scaler_total), root_clv=None,
            scaler_sites=np.asarray(sc_sites)[:n_obs].astype(np.int64))

    # -- evaluation ----------------------------------------------------------

    def log_likelihood(self, keep_root_clv: bool = False,
                       method: str = "auto") -> TreeLikelihoodResult:
        """Evaluate the tree log-likelihood.

        ``method``: "auto" (the whole-tree kernel on a GPU where it
        covers the model, else the XLA traversal), "fused" (the kernel;
        interpreted when ``config.interpret``) or "per-node" (the XLA
        traversal; needed when the root CLV must be kept).  The
        result's ``method`` names the path that ran.
        """
        method = self.resolve_method(method, keep_root_clv)
        out = self._run(method, keep_root_clv)
        lik, sc = np.asarray(out[0]), np.asarray(out[1])
        scaler_total = int(np.sum(sc.astype(np.int64)
                                  * np.asarray(self._wgt_dev)))
        # Final log/sum on host in float64 (device x64 is disabled by
        # default; the n-term sum wants the precision anyway).
        res = self._finalise_ll(lik, sc, scaler_total)
        res.method = method
        if keep_root_clv:
            res.root_clv = out[2]
        return res

    # -- multi-device: site-sharded traversal -------------------------------

    def log_likelihood_sharded(self, mesh=None,
                               method: str = "auto") -> TreeLikelihoodResult:
        """Whole-tree likelihood with the site axis sharded over a device
        mesh: each device runs the traversal (``method`` as in
        :meth:`log_likelihood`) on its site shard; the weighted
        log-likelihood partials and scaler counts merge with a single
        psum (the only cross-device traffic — the site dimension is
        pointwise, SURVEY.md §2.5).
        """
        from jax.sharding import NamedSharding, PartitionSpec as P
        from ..parallel.sharding import make_mesh

        cfg = self.config
        mesh = mesh or make_mesh()
        method = self.resolve_method(method)
        ndev = mesh.shape["sites"]
        n = self.n_sites
        unit = ndev * cfg.block_sites
        n_pad = max(unit, -(-n // unit) * unit)
        shard = n_pad // ndev
        codes = self._codes
        if codes.shape[-1] < n_pad:
            codes = jnp.pad(codes, ((0, 0), (0, n_pad - codes.shape[-1])),
                            constant_values=cfg.states)
        spec_s = P(None, "sites")
        codes = jax.device_put(codes, NamedSharding(mesh, spec_s))
        wgt = np.zeros((1, n_pad), np.int32)
        wgt[0, :n] = self.wgt
        wgt = jax.device_put(wgt, NamedSharding(mesh, spec_s))
        fn = self._jitted.get(("sharded", method, mesh))
        if fn is None:
            site_lik = self.site_lik_fn(method)

            def local(codes_s, lops, rops, wgt_s, ns):
                rank = jax.lax.axis_index("sites")
                n_local = jnp.clip(ns - rank * shard, 0, shard)
                lik, sc = site_lik(codes_s, lops, rops, n_local)
                valid = jnp.arange(shard) < n_local
                site_ll = jnp.where(
                    valid, jnp.log(jnp.maximum(lik, LIK_FLOOR)), 0.0)
                w = wgt_s[0]
                ll_part = jax.lax.psum(
                    jnp.sum(site_ll * w.astype(jnp.float32)), "sites")
                sc_part = jax.lax.psum(jnp.sum(sc * w), "sites")
                return lik[None], sc[None], ll_part, sc_part

            rep = P()
            fn = jax.jit(jax.shard_map(
                local, mesh=mesh,
                in_specs=(spec_s, rep, rep, spec_s, rep),
                out_specs=(spec_s, spec_s, rep, rep),
                check_vma=False))
            self._jitted[("sharded", method, mesh)] = fn
        lik, sc_sites, ll_sum, scaler_total = fn(
            codes, *self._ops, wgt, jnp.int32(n))
        scaler_total = int(scaler_total)
        if self.ascertainment == "lewis":
            res = self._finalise_ll(np.asarray(lik)[0],
                                    np.asarray(sc_sites)[0], scaler_total)
        else:
            ll = float(ll_sum) + scaler_total * LOG_MINLIK
            lik_h = np.asarray(lik, np.float64)[0, :n]
            # Same LIK_FLOOR floor as _finalise_ll: the 1-pass bf16
            # variant can round near-underflow likelihoods negative, and
            # this per-site array feeds RELL/site outputs.
            res = TreeLikelihoodResult(
                log_likelihood=ll,
                site_log_likelihood=np.log(np.maximum(lik_h, LIK_FLOOR)),
                scaler_total=scaler_total, root_clv=None,
                scaler_sites=np.asarray(sc_sites)[0, :n].astype(np.int64))
        res.method = method
        return res

    # -- brute-force oracle (tests) -----------------------------------------

    def log_likelihood_bruteforce(self) -> float:
        """Float64 state-space pruning with explicit P matrices (oracle)."""
        m, cfg = self.model, self.config
        S, C = m.states, cfg.categories
        n = self.n_sites
        partials: Dict[int, np.ndarray] = {}
        from ..io.alignment import AMBIGUITY
        amb = AMBIGUITY.get(S, ())
        for leaf in range(self.tree.n_leaves):
            si = self.tip_states[leaf]
            onehot = np.zeros((n, S))
            valid = (si >= 0) & (si < S)
            onehot[np.arange(n)[valid], si[valid]] = 1.0
            for k, members in enumerate(amb):
                hit = si == S + k
                for mem in members:
                    onehot[hit, mem] = 1.0
            gap = (si < 0) | (si >= S + len(amb))
            onehot[gap] = 1.0
            partials[leaf] = np.repeat(onehot[:, None, :], C, axis=1)
        for parent, lc, rc, tl, tr in self.schedule:
            out = np.empty((n, C, S))
            for c in range(C):
                P1 = m.p_matrix(tl, self.rates[c])
                P2 = m.p_matrix(tr, self.rates[c])
                out[:, c, :] = (partials[lc][:, c, :] @ P1.T) * (
                    partials[rc][:, c, :] @ P2.T)
            partials[parent] = out
        root = partials[self.tree.root]
        lik = (root @ m.pi) @ self.rate_weights
        return float(np.sum(np.log(lik) * self.wgt))


def _validate_batch_identity(pms) -> None:
    """Same-ALIGNMENT/model validation for the batch scorer.

    Shape equality alone is not enough: two models over different
    alignments (or substitution models / rates) of identical shape
    would pass a shape check and return silently wrong likelihoods.
    Sharing via ``share_device_from`` makes the arrays identical
    objects, so the common case costs `is` checks only.
    """
    pm0 = pms[0]
    for pm in pms[1:]:
        same_aln = (pm.tip_states is pm0.tip_states
                    or (pm.tip_states.shape == pm0.tip_states.shape
                        and np.array_equal(pm.tip_states, pm0.tip_states)))
        same_wgt = (pm.wgt is pm0.wgt or np.array_equal(pm.wgt, pm0.wgt))
        same_model = (pm.model is pm0.model
                      or (np.array_equal(pm.model.pi, pm0.model.pi)
                          and np.array_equal(pm.model.eigenvalues,
                                             pm0.model.eigenvalues)
                          and np.array_equal(pm.model.u, pm0.model.u)))
        if (not same_aln or not same_wgt or not same_model
                or not np.array_equal(pm.rates, pm0.rates)
                or not np.array_equal(pm.rate_weights, pm0.rate_weights)):
            raise ValueError(
                "batch scoring needs identical alignment/weights/model/"
                "rates across candidates (only topology and branch "
                "lengths may differ); build candidates with "
                "share_device_from")


def _batch_budget_bytes() -> int:
    """Device memory the batch scorer's arenas may take: a quarter of
    the device's limit where the runtime reports one, else 2 GiB."""
    stats = jax.devices()[0].memory_stats() or {}
    limit = stats.get("bytes_limit")
    return int(limit) // 4 if limit else 2 << 30


def batch_log_likelihood(pms) -> np.ndarray:
    """Score many same-shape topologies in ONE device program.

    ``pms``: PhyloModels sharing alignment, model, config and node count
    (the tree-search neighbourhood case — NNI/SPR preserve all of these).
    The schedule of each candidate runs as data (ops/tree_xla
    .traverse_dynamic), so the batch compiles ONCE per (n_edges,
    n_slots, n_pad) shape class; candidates are vmapped in chunks sized
    to a quarter of the device's memory (:func:`_batch_budget_bytes`).

    Returns (B,) float64 log-likelihoods (fp32 partial sums, host fp64
    final reduction).
    """
    from ..ops.tree_xla import batch_loglik_parts

    pm0 = pms[0]
    cfg = pm0.config
    n_leaves = pm0.tree.n_leaves
    E = len(pm0.schedule)
    for pm in pms[1:]:
        if (len(pm.schedule) != E or pm.tree.n_leaves != n_leaves
                or pm.n_pad != pm0.n_pad or pm.config != cfg):
            raise ValueError("batch_log_likelihood needs same-shape models")
    _validate_batch_identity(pms)
    if pm0.ascertainment is not None:
        raise ValueError("ascertainment not supported in the batch path")

    regs = [compile_register_schedule(pm._sched_r, n_leaves) for pm in pms]
    n_slots = max(ns for _, ns, _ in regs)
    B = len(pms)
    chunk = batch_chunk(B, n_slots, cfg.rows, pm0.n_pad,
                        _batch_budget_bytes())
    pad = -B % chunk
    idx = list(range(B)) + [B - 1] * pad
    sched = tuple(
        jnp.asarray(np.stack([regs[i][0][k] for i in idx]))
        for k in range(5)) + (
        jnp.asarray(np.asarray([regs[i][2] for i in idx], np.int32)),)
    # host-stack the whole neighbourhood's operators -> ONE upload
    lops = jnp.asarray(np.stack([pms[i]._lops_np for i in idx]))
    rops = jnp.asarray(np.stack([pms[i]._rops_np for i in idx]))
    n_parts = pm0.n_pad // cfg.block_sites
    parts = batch_loglik_parts(
        pm0._codes, pm0._tip_table, lops, rops, sched, pm0._ev,
        pm0._root_rows, pm0._wgt_dev.astype(jnp.float32),
        jnp.int32(pm0.n_sites), n_slots=n_slots, n_parts=n_parts,
        chunk=chunk, variant=cfg.resolved_kernel_variant,
        dtype=jnp.dtype(cfg.dtype))
    return np.asarray(parts, np.float64).sum(axis=1)[:B]
