"""Differentiable tree likelihood + on-device branch-length optimisation.

The reference's roadmap wants "updating PLF parameters from the FPGA"
(README.md:201-205) — here branch transition matrices are jit inputs
computed from branch lengths *inside* the compiled graph, so
``jax.value_and_grad`` gives exact dLL/dt for every branch in one
backward pass, and an optax loop maximises the likelihood entirely
on-device.  (RAxML does this with hand-coded Newton iterations on one
branch at a time; here all branches update simultaneously.)

The likelihood is the XLA traversal (ops/tree_xla.traverse) and its
gradient is plain autodiff of it: XLA differentiates and fuses the
element-wise stages.  With a ``mesh`` the traversal runs site-sharded
under ``shard_map`` and the operator cotangents psum across devices.

Underflow rescaling is kept: the 2^32 factors are constant w.r.t.
branch lengths almost everywhere, so gradients are exact wherever the
likelihood is differentiable.
"""

from __future__ import annotations

from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..ops.tree_xla import traverse
from .phylo import LIK_FLOOR, LOG_MINLIK, PhyloModel

__all__ = ["tree_loglik_fn", "optimize_branch_lengths", "optimize_alpha",
           "optimize_pinv", "fit_model", "fit_codon"]


def _branch(u, lam, t, r_vec):
    """(C, S, S) branch matrices ``[c, k, a] = u[k, a] exp(lam_a t r_c)``
    (substitution.branch_matrices as a differentiable jnp function)."""
    e = jnp.exp(lam[None, :] * t * r_vec[:, None])       # (C, S)
    return u[None, :, :] * e[:, None, :]


def _ll_from_sites(lik, sc, wpad, asc, d0, n, w_total):
    """Weighted log-likelihood from per-site likelihoods and rescale
    counts (fp32 on device), with the Lewis correction when ``asc``."""
    site_ll = jnp.log(jnp.maximum(lik, jnp.float32(LIK_FLOOR)))
    sc_f = sc.astype(jnp.float32)
    ll = (jnp.sum(site_ll * wpad)
          + jnp.sum(sc_f * wpad) * jnp.float32(LOG_MINLIK))
    if asc:
        log_pc = site_ll[d0:n] + sc_f[d0:n] * jnp.float32(LOG_MINLIK)
        ll = ll - w_total * jnp.log1p(-jnp.sum(jnp.exp(log_pc)))
    return ll


def _tree_loglik_parts(pm: PhyloModel, mesh=None):
    """``(loglik, consts, t0)``: a pure jittable
    ``loglik(t_vec, r_vec, w_vec, *consts)`` with the device-resident
    alignment in ``consts`` (arguments, never lowering constants)."""
    cfg = pm.config
    S = cfg.states
    model = pm.model
    n_leaves = pm.tree.n_leaves
    n, n_pad = pm.n_sites, pm.n_pad
    sched = tuple((p, l, r) for (p, l, r, *_x) in pm._sched_r)
    left = np.asarray([l for (_, l, _) in sched])
    right = np.asarray([r for (_, _, r) in sched])
    u = jnp.asarray(model.u, jnp.float32)             # (S, S) [state, eig]
    lam = jnp.asarray(model.eigenvalues, jnp.float32)
    pi_u = jnp.asarray(model.root_vector, jnp.float32)
    variant = cfg.resolved_kernel_variant
    dtype = jnp.dtype(cfg.dtype)

    codes = pm._codes
    if mesh is not None:
        from jax.sharding import NamedSharding, PartitionSpec as P
        ndev = mesh.shape["sites"]
        unit = ndev * cfg.block_sites
        n_pad = max(unit, -(-n // unit) * unit)
        shard = n_pad // ndev
        if codes.shape[-1] < n_pad:
            codes = jnp.pad(codes, ((0, 0), (0, n_pad - codes.shape[-1])),
                            constant_values=S)
        codes = jax.device_put(codes, NamedSharding(mesh, P(None, "sites")))
    # Site weights ride as an ARGUMENT (O(sites) closure constants would
    # embed in the lowered module).
    wpad = np.zeros(n_pad, np.float32)
    wpad[:n] = pm.wgt
    wpad = jnp.asarray(wpad)
    consts = (codes, wpad, pm._ev, pm._tip_table)

    def site_terms(codes, lops, rops, ev, ttab, rr, n_valid):
        lik, sc, _ = traverse(codes, lops, rops, ev, ttab, rr, n_valid,
                              schedule=sched, n_leaves=n_leaves,
                              variant=variant, dtype=dtype)
        return lik, sc

    if mesh is not None:
        from jax.sharding import PartitionSpec as P

        def local(codes_s, lops, rops, ev, ttab, rr):
            rank = jax.lax.axis_index("sites")
            n_local = jnp.clip(n - rank * shard, 0, shard)
            return site_terms(codes_s, lops, rops, ev, ttab, rr, n_local)

        rep = P()
        site_terms_mesh = jax.shard_map(
            local, mesh=mesh,
            in_specs=(P(None, "sites"), rep, rep, rep, rep, rep),
            out_specs=(P("sites"), P("sites")), check_vma=False)
    asc = pm.ascertainment == "lewis"
    d0 = pm.n_sites_obs
    w_total = float(np.sum(pm.wgt))

    def loglik(t_vec, r_vec, w_vec, codes, wpad, ev, ttab):
        branch = jax.vmap(lambda t: _branch(u, lam, t, r_vec))
        lops, rops = branch(t_vec[left]), branch(t_vec[right])
        rr = pi_u[:, None] * w_vec[None, :]               # (S, C)
        if mesh is None:
            lik, sc = site_terms(codes, lops, rops, ev, ttab, rr, n)
        else:
            lik, sc = site_terms_mesh(codes, lops, rops, ev, ttab, rr)
        return _ll_from_sites(lik, sc, wpad, asc, d0, n, w_total)

    t0 = np.array([pm.tree.nodes[i].length
                   for i in range(pm.tree.n_nodes - 1)], np.float32)
    return loglik, consts, t0


def tree_loglik_fn(pm: PhyloModel, with_rates: bool = False,
                   with_weights: bool = False, mesh=None):
    """Build ``(branch_lengths) -> log_likelihood`` as a pure jittable fn.

    ``branch_lengths``: (n_nodes-1,) vector indexed by child node (every
    node except the root owns the branch to its parent).  Returns
    (fn, t0) with t0 the tree's current lengths.  With ``with_rates`` the
    fn signature is ``(t_vec, rates)`` — the (C,) gamma category rates
    become a traced input (one compilation serves every alpha during a
    gamma-shape line search).  ``with_weights`` additionally traces the
    (C,) category mixture weights — ``(t_vec, rates, weights)`` — for
    +I proportion searches (implies with_rates).

    The path is the XLA traversal, differentiated by autodiff (no kernel
    has a gradient rule).  ``mesh``: a Mesh with a "sites" axis to shard
    the traversal over.  ``fn.engine`` and ``fn.variant`` name the path
    and the kernel variant that run.

    ``fn.data`` holds the device-resident alignment arrays the fn reads;
    they may also be passed as trailing arguments, ``fn(t_vec, *data)``.
    Jitting ``jax.value_and_grad(fn)`` and calling it with
    ``(t_vec, *fn.data)`` keeps the alignment an argument of the compiled
    program rather than a constant folded into it: the program compiles
    faster, and it serves every alignment of the same site count and
    site weights, such as equal slices of one alignment.
    """
    if pm.config.resolved_kernel_variant == "mxu_bf16":
        # 1-pass bf16 rounds near-underflow site likelihoods negative
        # through deep trees — any optimisation through it silently fits
        # noise.
        raise ValueError(
            "kernel_variant='mxu_bf16' is a bandwidth mode for forward "
            "streaming only; its likelihood drift makes optimisation "
            "unsound — use 'mxu_3x' or 'mxu' for training/fitting")
    loglik, consts, t0 = _tree_loglik_parts(pm, mesh=mesh)
    jfn = jax.jit(loglik)
    rates = jnp.asarray(pm.rates, jnp.float32)
    cw = jnp.asarray(pm.rate_weights, jnp.float32)
    if with_weights:
        def fn(t_vec, r_vec, w_vec, *data):
            return jfn(t_vec, r_vec, w_vec, *(data or consts))
    elif with_rates:
        def fn(t_vec, r_vec, *data):
            return jfn(t_vec, r_vec, cw, *(data or consts))
    else:
        def fn(t_vec, *data):
            return jfn(t_vec, rates, cw, *(data or consts))
    fn.data = consts
    fn.engine = "xla"
    fn.variant = pm.config.resolved_kernel_variant
    return fn, t0


def optimize_branch_lengths(pm: PhyloModel, steps: int = 100,
                            learning_rate: float = 0.02,
                            min_length: float = 1e-6, mesh=None
                            ) -> Tuple[np.ndarray, float, float]:
    """Maximise the tree likelihood over all branch lengths on device.

    Optimises in log-space (lengths stay positive) with optax adam; one
    jitted step takes the alignment as arguments.  With ``mesh`` the
    forward/backward traversal runs site-sharded over the device mesh.
    Returns (optimised_lengths, ll_before, ll_after).
    """
    import optax

    loglik, consts, t0 = _tree_loglik_parts(pm, mesh=mesh)
    rates = jnp.asarray(pm.rates, jnp.float32)
    cw = jnp.asarray(pm.rate_weights, jnp.float32)
    opt = optax.adam(learning_rate)

    def loss(log_t, *consts):
        return -loglik(jnp.exp(log_t) + min_length, rates, cw, *consts)

    @jax.jit
    def step(log_t, state, *consts):
        val, g = jax.value_and_grad(loss)(log_t, *consts)
        updates, state = opt.update(g, state)
        return optax.apply_updates(log_t, updates), state, val

    ll_at = jax.jit(lambda t, *consts: loglik(t, rates, cw, *consts))
    ll0 = float(ll_at(jnp.asarray(t0), *consts))
    log_t = jnp.log(jnp.maximum(jnp.asarray(t0), min_length))
    state = opt.init(log_t)
    for _ in range(steps):
        log_t, state, _ = step(log_t, state, *consts)
    t_opt = np.asarray(jnp.exp(log_t) + min_length)
    ll1 = float(ll_at(jnp.asarray(t_opt), *consts))
    return t_opt, ll0, ll1


def _golden_section(f, lo: float, hi: float, iters: int = 30):
    """Maximise a unimodal scalar function on [lo, hi]."""
    invphi = (np.sqrt(5.0) - 1.0) / 2.0
    a, b = lo, hi
    c = b - invphi * (b - a)
    d = a + invphi * (b - a)
    fc, fd = f(c), f(d)
    for _ in range(iters):
        if fc > fd:
            b, d, fd = d, c, fc
            c = b - invphi * (b - a)
            fc = f(c)
        else:
            a, c, fc = c, d, fd
            d = a + invphi * (b - a)
            fd = f(d)
    x = (a + b) / 2.0
    return x, f(x)


def optimize_alpha(pm: PhyloModel, alpha_bounds=(0.02, 100.0),
                   iters: int = 30) -> Tuple[float, float, float]:
    """Maximum-likelihood gamma shape (alpha) at fixed tree and lengths.

    Golden-section search in log-alpha (RAxML optimises alpha with Brent
    on the same 1-D profile).  The discrete-gamma quantile discretisation
    runs on host per candidate; the tree likelihood is ONE compiled
    function of the (C,) rate vector, so the line search costs ~``iters``
    device calls and a single compilation.

    Returns (alpha_hat, ll_before, ll_after); ``ll_before`` uses the
    PhyloModel's current rates.
    """
    from .substitution import discrete_gamma_rates, gamma_invariant_rates

    C = pm.config.categories
    fn, t0 = tree_loglik_fn(pm, with_rates=True)
    t_dev = jnp.asarray(t0)
    ll0 = float(fn(t_dev, jnp.asarray(pm.rates, jnp.float32)))

    def rates_of(alpha: float) -> np.ndarray:
        # +I models carry the rate-0 category at index 0 and C-1 gamma
        # categories (the mixture weights are fixed in the compiled fn).
        if pm.p_inv is not None:
            return gamma_invariant_rates(alpha, pm.p_inv, C - 1)[0]
        return discrete_gamma_rates(alpha, C)

    def ll_of_log_alpha(la: float) -> float:
        r = rates_of(float(np.exp(la)))
        return float(fn(t_dev, jnp.asarray(r, jnp.float32)))

    la, ll1 = _golden_section(ll_of_log_alpha, np.log(alpha_bounds[0]),
                              np.log(alpha_bounds[1]), iters)
    return float(np.exp(la)), ll0, ll1


def optimize_pinv(pm: PhyloModel, alpha: Optional[float] = None,
                  bounds=(1e-4, 0.99), iters: int = 30
                  ) -> Tuple[float, float, float]:
    """Maximum-likelihood invariant-site proportion (+I / +I+G profile).

    ``pm`` must have been built with ``p_inv`` (so the rate-0 category
    exists).  Golden-section search over p_inv at fixed tree, lengths
    and gamma shape ``alpha`` (default: the shape implied by pm.rates);
    both the rate rescaling 1/(1-p_inv) and the mixture weights vary per
    candidate through ONE compiled likelihood (weights are traced).

    Returns (p_inv_hat, ll_before, ll_after).
    """
    from .substitution import gamma_invariant_rates

    if pm.p_inv is None:
        raise ValueError("build the PhyloModel with p_inv to optimise it")
    C = pm.config.categories            # includes the invariant category
    fn, t0 = tree_loglik_fn(pm, with_weights=True)
    t_dev = jnp.asarray(t0)
    ll0 = float(fn(t_dev, jnp.asarray(pm.rates, jnp.float32),
                   jnp.asarray(pm.rate_weights, jnp.float32)))
    # Gamma rates at weight-free scale; candidate p rescales them.
    if alpha is None:
        base_g = np.asarray(pm.rates[1:]) * (1.0 - pm.p_inv)
    else:
        from .substitution import discrete_gamma_rates
        base_g = discrete_gamma_rates(alpha, C - 1)

    def ll_of(p: float) -> float:
        rates = np.concatenate([[0.0], base_g / (1.0 - p)])
        weights = np.concatenate([[p], np.full(C - 1, (1.0 - p) / (C - 1))])
        return float(fn(t_dev, jnp.asarray(rates, jnp.float32),
                        jnp.asarray(weights, jnp.float32)))

    p_hat, ll1 = _golden_section(ll_of, bounds[0], bounds[1], iters)
    return float(p_hat), ll0, ll1


# ---------------------------------------------------------------------------
# Full model fitting: GTR exchangeabilities + base frequencies + branch
# lengths, all by gradient ascent with the eigendecomposition INSIDE the
# compiled graph (jnp.linalg.eigh is differentiable for the symmetrised
# reversible form).  The gamma shape alpha stays an outer-loop scalar
# (its discretisation uses a quantile function with no stable jax grad).
# ---------------------------------------------------------------------------


def _gtr_eigen_jnp(log_rates, logits_pi, S):
    """Differentiable reversible-Q eigensystem (substitution._make in jnp).

    Returns (lam, u, w, pi).  Caution: exactly degenerate eigenvalues
    (e.g. literal JC69) make eigh gradients NaN — start from slightly
    perturbed rates.
    """
    rates = jnp.exp(log_rates)
    pi = jax.nn.softmax(logits_pi)
    iu = np.triu_indices(S, 1)
    qsym = jnp.zeros((S, S)).at[iu].set(rates)
    qsym = qsym + qsym.T
    q = qsym * pi[None, :]
    q = q - jnp.diag(jnp.sum(q, axis=1))
    rate = -jnp.sum(pi * jnp.diag(q))
    q = q / rate
    d = jnp.sqrt(pi)
    b = (q * d[:, None]) / d[None, :]
    b = 0.5 * (b + b.T)
    lam, v = jnp.linalg.eigh(b)
    u = v / d[:, None]
    w = v.T * d[None, :]
    return lam, u, w, pi


def fit_model(pm: PhyloModel, steps: int = 150, learning_rate: float = 0.02,
              min_length: float = 1e-6, fit_lengths: bool = True,
              fit_alpha: bool = False, alpha_rounds: int = 2,
              alpha_bounds=(0.02, 100.0), seed: int = 0):
    """Maximum-likelihood fit of GTR rates, frequencies and branch lengths.

    Starts from the PhyloModel's current model/lengths (rates jittered to
    avoid eigh degeneracies).  Returns
    ``(fitted SubstitutionModel, fitted lengths, ll_before, ll_after)``.

    With ``fit_alpha`` the gamma shape is fitted too, by coordinate
    descent: the adam steps split into ``alpha_rounds`` epochs with a
    golden-section alpha line search after each (the discretisation's
    quantile function has no stable jax gradient, so alpha stays an
    outer-loop scalar; every line-search step reuses the one compiled
    likelihood because the (C,) rate vector is a traced input).  With
    ``fit_alpha`` the return gains a fifth element: ``(..., alpha_hat)``.
    """
    import optax
    from ..io.alignment import tip_expansion_table

    cfg = pm.config
    S, C = cfg.states, cfg.categories
    n_leaves = pm.tree.n_leaves
    sched = tuple((p, l, r) for (p, l, r, *_x) in pm._sched_r)
    left = np.asarray([l for (_, l, _) in sched])
    right = np.asarray([r for (_, _, r) in sched])
    rates_gamma = jnp.asarray(pm.rates, jnp.float32)
    cw = jnp.asarray(pm.rate_weights, jnp.float32)
    n = pm.n_sites
    wpad = np.zeros(pm.n_pad, np.float32)
    wpad[:n] = pm.wgt
    wpad = jnp.asarray(wpad)
    codes_dev = pm._codes
    asc = pm.ascertainment == "lewis"
    d0 = pm.n_sites_obs
    w_total = float(np.sum(pm.wgt))

    # Initial parameters from the current model: recover the
    # exchangeabilities from Q = U diag(lam) W via qsym[i,j] = q[i,j]/pi[j].
    m0 = pm.model
    q0 = (m0.u * m0.eigenvalues[None, :]) @ m0.w
    iu = np.triu_indices(S, 1)
    ex0 = np.clip(q0[iu] / m0.pi[iu[1]], 1e-3, None)
    rng = np.random.default_rng(seed)
    ex0 = ex0 * np.exp(rng.normal(0, 1e-3, ex0.shape))  # break degeneracy
    params0 = {
        "log_rates": jnp.asarray(np.log(ex0), jnp.float32),
        "logits_pi": jnp.asarray(np.log(m0.pi), jnp.float32),
        "log_t": jnp.log(jnp.maximum(jnp.asarray(
            [pm.tree.nodes[i].length for i in range(pm.tree.n_nodes - 1)],
            dtype=jnp.float32), min_length)),
    }

    def loglik(params, rates_gamma, codes):
        # codes is a jit ARGUMENT: closing over it embeds the whole tip
        # matrix as a lowering constant.
        lam, u, w, pi = _gtr_eigen_jnp(params["log_rates"],
                                       params["logits_pi"], S)
        lam = lam.astype(jnp.float32)
        u = u.astype(jnp.float32)
        w = w.astype(jnp.float32)
        t_vec = jnp.exp(params["log_t"]) + min_length
        if not fit_lengths:
            t_vec = jax.lax.stop_gradient(t_vec)
        branch = jax.vmap(lambda t: _branch(u, lam, t, rates_gamma))
        rr = (pi @ u)[:, None] * cw[None, :]
        lik, sc, _ = traverse(
            codes, branch(t_vec[left]), branch(t_vec[right]), w.T,
            tip_expansion_table(w, S), rr, n, schedule=sched,
            n_leaves=n_leaves, variant=cfg.resolved_kernel_variant)
        return _ll_from_sites(lik, sc, wpad, asc, d0, n, w_total)

    _loglik_j = jax.jit(loglik)
    loglik_c = lambda params, rg: _loglik_j(params, rg, codes_dev)
    rg = rates_gamma
    ll0 = float(loglik_c(params0, rg))
    opt = optax.adam(learning_rate)
    state = opt.init(params0)

    @jax.jit
    def _step(params, state, rg, codes):
        val, g = jax.value_and_grad(
            lambda p: -loglik(p, rg, codes))(params)
        updates, state = opt.update(g, state)
        return optax.apply_updates(params, updates), state, val

    step = lambda params, state, rg: _step(params, state, rg, codes_dev)

    params = params0
    alpha_hat = None
    if fit_alpha:
        from .substitution import discrete_gamma_rates, gamma_invariant_rates

        def rates_of(alpha: float) -> np.ndarray:
            if pm.p_inv is not None:
                return gamma_invariant_rates(alpha, pm.p_inv, C - 1)[0]
            return discrete_gamma_rates(alpha, C)

        epochs = max(1, alpha_rounds)
        per = max(1, steps // epochs)
        for _ in range(epochs):
            for _ in range(per):
                params, state, _ = step(params, state, rg)

            def ll_of_la(la, params=params):
                r = rates_of(float(np.exp(la)))
                return float(loglik_c(params, jnp.asarray(r, jnp.float32)))

            la, _ = _golden_section(ll_of_la, np.log(alpha_bounds[0]),
                                    np.log(alpha_bounds[1]), iters=25)
            alpha_hat = float(np.exp(la))
            rg = jnp.asarray(rates_of(alpha_hat), jnp.float32)
    else:
        for _ in range(steps):
            params, state, _ = step(params, state, rg)
    ll1 = float(loglik_c(params, rg))

    # materialise the fitted model on host
    from .substitution import gtr
    fitted = gtr(np.exp(np.asarray(params["log_rates"], np.float64)),
                 np.asarray(jax.nn.softmax(params["logits_pi"]),
                            np.float64))
    t_opt = np.asarray(jnp.exp(params["log_t"]) + min_length)
    if fit_alpha:
        return fitted, t_opt, ll0, ll1, alpha_hat
    return fitted, t_opt, ll0, ll1


# ---------------------------------------------------------------------------
# Codon-model fitting: ML estimation of the GY94 omega (dN/dS) and kappa
# on the 2-D profile likelihood.  dN/dS estimation is the reason codon
# models exist; this is the host-side model workflow around the S=61
# kernel path (the reference computes the PLF under caller-supplied
# operators, /root/reference/app/src/plf.cpp:8-68 — producing those
# operators from data is the production step above it).
# ---------------------------------------------------------------------------


def fit_codon(tree, tip_states, wgt=None, alpha: Optional[float] = None,
              config=None, pi: Optional[np.ndarray] = None,
              kappa0: float = 2.0, omega0: float = 0.5,
              kappa_bounds=(0.2, 40.0), omega_bounds=(1e-3, 10.0),
              rounds: int = 3, iters: int = 10,
              fit_lengths: bool = True, length_steps: int = 60,
              fit_alpha: bool = False, verbose: bool = False):
    """Maximum-likelihood GY94 fit: omega (dN/dS), kappa, F3x4
    frequencies, branch lengths (and optionally the gamma shape).

    ``tip_states``: (n_leaves, n_codons) codon state codes
    (substitution.encode_codon_alignment).  Frequencies default to the
    F3x4 estimate from the data (substitution.f3x4_from_codes).

    Strategy: coordinate golden-section on the (log kappa, log omega)
    profile — each candidate rebuilds the 61-state eigendecomposition
    on host (~ms) and evaluates ONE whole-tree likelihood on device;
    all evaluations share a single compiled kernel per tree shape, so
    a fit costs ~``2 * rounds * iters`` device calls.  Branch lengths
    are fitted under the initial model (device autodiff through the dot
    form — ``kernel_variant`` auto-resolves to mxu_3x at S=61) and
    re-fitted under the winner.  The 2-D profile is smooth and
    near-unimodal in practice (the standard codeml experience); use
    more ``rounds`` for flat likelihood surfaces.

    Returns ``(model, info)`` with ``info`` a dict holding kappa,
    omega, alpha, lengths (node-indexed vector) and ll.
    """
    from ..config import PLFConfig
    from .phylo import PhyloModel
    from .substitution import codon_gy94, f3x4_from_codes
    from .tree import Tree, TreeNode

    codes = np.asarray(tip_states)
    if pi is None:
        pi = f3x4_from_codes(codes, wgt)
    cfg = config or PLFConfig(states=61, kernel_variant="auto",
                              block_sites=1024)

    def with_lengths(t: Tree, t_vec) -> Tree:
        nodes = [TreeNode(n.index, n.name,
                          float(t_vec[n.index]) if n.index < len(t_vec)
                          else n.length, n.children)
                 for n in t.nodes]
        return Tree(nodes=nodes, root=t.root)

    kappa, omega = float(kappa0), float(omega0)
    alpha_hat = alpha

    def ll_of(k: float, w: float, t: Tree) -> float:
        m = codon_gy94(k, w, pi)
        pm = PhyloModel(t, m, codes, wgt=wgt, alpha=alpha_hat,
                        config=cfg)
        return pm.log_likelihood().log_likelihood

    # initial branch lengths under the starting model
    if fit_lengths:
        pm = PhyloModel(tree, codon_gy94(kappa, omega, pi), codes,
                        wgt=wgt, alpha=alpha_hat, config=cfg)
        t_opt, _, _ = optimize_branch_lengths(pm, steps=length_steps)
        tree = with_lengths(tree, np.asarray(t_opt))

    for r in range(rounds):
        lw, _ = _golden_section(
            lambda x: ll_of(kappa, float(np.exp(x)), tree),
            np.log(omega_bounds[0]), np.log(omega_bounds[1]), iters)
        omega = float(np.exp(lw))
        lk, _ = _golden_section(
            lambda x: ll_of(float(np.exp(x)), omega, tree),
            np.log(kappa_bounds[0]), np.log(kappa_bounds[1]), iters)
        kappa = float(np.exp(lk))
        if fit_alpha:
            pm = PhyloModel(tree, codon_gy94(kappa, omega, pi), codes,
                            wgt=wgt, alpha=alpha_hat or 0.5, config=cfg)
            alpha_hat, _, _ = optimize_alpha(pm)
        if verbose:
            print(f"fit_codon round {r}: kappa={kappa:.3f} "
                  f"omega={omega:.4f} alpha={alpha_hat}", flush=True)

    model = codon_gy94(kappa, omega, pi)
    if fit_lengths:
        pm = PhyloModel(tree, model, codes, wgt=wgt, alpha=alpha_hat,
                        config=cfg)
        t_opt, _, ll = optimize_branch_lengths(pm,
                                               steps=length_steps // 2)
        tree = with_lengths(tree, np.asarray(t_opt))
    else:
        t_opt = np.asarray([tree.nodes[i].length
                            for i in range(tree.n_nodes - 1)])
        ll = ll_of(kappa, omega, tree)
    info = dict(kappa=kappa, omega=omega, alpha=alpha_hat,
                lengths=np.asarray(t_opt), ll=float(ll), pi=pi,
                tree=tree)
    return model, info
