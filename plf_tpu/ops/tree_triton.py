"""Whole-tree likelihood as one Pallas kernel through Triton (DNA).

The per-node XLA traversal (ops/tree_xla.py) writes every internal CLV
to device memory and reads it back: for 160 taxa that is about 159 x
192 B per site.  This kernel runs the whole post-order traversal of a
site block in one program and moves only the tip codes in and one
likelihood plus one rescale count out — about ``n_leaves + 8`` bytes per
site — while the live CLVs stay in a small per-program slot arena that
the L2 cache holds.

Design:

* one program per power-of-two site block; blocks are independent;
* the (reordered, taller-child-first) schedule is DATA: a ``fori_loop``
  walks its register-machine arrays (ops/schedule
  .compile_register_schedule), so one compilation serves every tree of
  the same (edges, leaves, slots) shape class and the compile time does
  not grow with the tree (an unrolled schedule compiled in 14 s at 15
  nodes and 291 s at 63 on an H100 — PERF.md);
* a CLV is ``S*C`` separate ``(block,)`` row vectors; a node is the
  golden model's element-wise stages on them, with the branch and
  eigenvector entries as scalar loads;
* a tip is expanded from its int8/int32 codes where it is consumed (once
  per leaf in a binary tree); an internal child is read back from its
  arena slot, ``n_slots`` (the schedule's peak live count) x rows x block
  x 4 B per program;
* the 2^32 rescale is applied per node and counted per site, exactly as
  in the per-node path.

It covers the "vpu" variant of DNA-sized models; :func:`covers` says
which.  On an H100 its per-site likelihoods and rescale counts equal the
XLA traversal's bit for bit at 16 and 160 taxa (PERF.md).  Nothing in
the design pins that: either compiler may contract multiply-adds into
FMAs differently, so the tests hold the per-site log-likelihoods to
rtol 5e-6.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pl_triton

from ..reference import MIN_LIKELIHOOD, TWO_TO_THE_32
from .schedule import compile_register_schedule

__all__ = ["plf_tree_triton", "covers", "choose_block", "MAX_STATES",
           "MAX_ROWS", "DEFAULT_BLOCK"]

#: Largest state count the kernel takes: its stages unroll S^2 * C
#: scalar-vector products per child (DNA).
MAX_STATES = 4

#: Largest CLV (S * C rows) the kernel takes: rows are live vectors.
MAX_ROWS = 16

#: Sites per program when the caller does not choose: two sites per
#: thread at NUM_WARPS warps, the fastest of 128/256/512 at 16 and 160
#: taxa on an H100 (PERF.md).
DEFAULT_BLOCK = 256

NUM_WARPS = 4


def covers(states: int, categories: int, variant: str) -> bool:
    """Whether the kernel handles this model."""
    return (states <= MAX_STATES and states * categories <= MAX_ROWS
            and variant == "vpu")


def choose_block(n_pad: int, block: int = DEFAULT_BLOCK) -> int:
    """Sites per program: the largest power of two up to ``block`` that
    divides ``n_pad``."""
    block = 1 << (max(1, block).bit_length() - 1)
    while block > 1 and n_pad % block:
        block //= 2
    return block


def _tree_kernel(n_ref, lsrc_ref, lflag_ref, rsrc_ref, rflag_ref, oslot_ref,
                 rslot_ref, codes_ref, ops_ref, ev_ref, ttab_ref, rr_ref,
                 lik_ref, sc_ref, arena_ref, *, n_edges, states, categories,
                 n_codes, block_sites, barrier):
    S, C, BS = states, categories, block_sites
    rows = S * C
    site = pl.program_id(0) * BS + jax.lax.broadcasted_iota(
        jnp.int32, (BS,), 0)
    valid = site < n_ref[0]
    ev = [[ev_ref[k, a] for a in range(S)] for k in range(S)]
    ttab = [[ttab_ref[a, s] for s in range(n_codes)] for a in range(S)]

    def operand(src, flag):
        def tip(_):
            code = codes_ref[src, :].astype(jnp.int32)
            out = []
            for a in range(S):
                v = jnp.where(code == 0, ttab[a][0], jnp.float32(0.0))
                for s in range(1, n_codes):
                    v = jnp.where(code == s, ttab[a][s], v)
                out += [v] * C
            return tuple(out)

        def slot(_):
            return tuple(arena_ref[src, r, :] for r in range(rows))

        return jax.lax.cond(flag == 1, slot, tip, None)

    def stage1(x, i, side, c, k):
        u = ops_ref[i, side, c, k, 0] * x[c]
        for a in range(1, S):
            u = u + ops_ref[i, side, c, k, a] * x[a * C + c]
        return u

    def body(i, scaler):
        x1 = operand(lsrc_ref[i], lflag_ref[i])
        x2 = operand(rsrc_ref[i], rflag_ref[i])
        p = [[stage1(x1, i, 0, c, k) * stage1(x2, i, 1, c, k)
              for c in range(C)] for k in range(S)]
        x3 = []
        for a in range(S):
            for c in range(C):
                v = ev[0][a] * p[0][c]
                for k in range(1, S):
                    v = v + ev[k][a] * p[k][c]
                x3.append(v)
        mx = jnp.abs(x3[0])
        for v in x3[1:]:
            mx = jnp.maximum(mx, jnp.abs(v))
        mask = jnp.logical_and(mx < MIN_LIKELIHOOD, valid)
        fac = jnp.where(mask, jnp.float32(TWO_TO_THE_32), jnp.float32(1.0))
        dst = oslot_ref[i]
        for r in range(rows):
            arena_ref[dst, r, :] = x3[r] * fac
        if barrier:
            # later iterations read these rows on other threads
            pl_triton.debug_barrier()
        return scaler + mask.astype(jnp.int32)

    scaler = jax.lax.fori_loop(0, n_edges, body,
                               jnp.zeros((BS,), jnp.int32))
    root = rslot_ref[0]
    lik = rr_ref[0, 0] * arena_ref[root, 0, :]
    for r in range(1, rows):
        lik = lik + rr_ref[r // C, r % C] * arena_ref[root, r, :]
    lik_ref[...] = lik
    sc_ref[...] = scaler


@functools.partial(jax.jit, static_argnames=(
    "n_slots", "block_sites", "interpret"))
def _tree_call(sched, codes, ops, ev, ttab, rr, n, *, n_slots, block_sites,
               interpret):
    S, C = ev.shape[0], ops.shape[2]
    n_leaves, n_pad = codes.shape
    n_prog = n_pad // block_sites

    def whole(x):
        return pl.BlockSpec(x.shape, lambda i: (0,) * x.ndim)

    kernel = functools.partial(
        _tree_kernel, n_edges=sched[0].shape[0], states=S, categories=C,
        n_codes=ttab.shape[-1], block_sites=block_sites,
        barrier=not interpret)
    sites = pl.BlockSpec((block_sites,), lambda i: (i,))
    n_arr = jnp.asarray(n, jnp.int32).reshape((1,))
    lik, sc, _ = pl.pallas_call(
        kernel,
        grid=(n_prog,),
        in_specs=[whole(n_arr)] + [whole(a) for a in sched] + [
            pl.BlockSpec((n_leaves, block_sites), lambda i: (0, i)),
            whole(ops), whole(ev), whole(ttab), whole(rr)],
        out_specs=[sites, sites,
                   pl.BlockSpec((None, n_slots, S * C, block_sites),
                                lambda i: (i, 0, 0, 0))],
        out_shape=[jax.ShapeDtypeStruct((n_pad,), jnp.float32),
                   jax.ShapeDtypeStruct((n_pad,), jnp.int32),
                   jax.ShapeDtypeStruct(
                       (n_prog, n_slots, S * C, block_sites), jnp.float32)],
        backend="triton",
        compiler_params=pl_triton.CompilerParams(num_warps=NUM_WARPS,
                                                 num_stages=1),
        interpret=interpret,
        name="plf_tree_triton",
    )(n_arr, *sched, codes, ops, ev, ttab, rr)
    return lik, sc


def plf_tree_triton(codes, schedule, ops, ev, tip_table, root_rows, n, *,
                    block_sites=None, interpret: bool = False):
    """Whole-tree per-site likelihood in one kernel.

    Args:
      codes: ``(n_leaves, n_pad)`` int8 or int32 tip codes.
      schedule: reordered schedule (ops/schedule.reorder_schedule); it is
        lowered to register-machine arrays that the kernel reads.
      ops: ``(E, 2, C, S, S)`` fp32 branch matrices of each entry's left
        (``[:, 0]``) and right (``[:, 1]``) child, in schedule order.
      ev: ``(S, S)`` eigenvector matrix; tip_table: ``(S, ncode)``;
      root_rows: ``(S, C)`` root weights; n: valid site count.
      block_sites: sites per program (default :func:`choose_block`).
      interpret: run the Pallas interpreter (CPU tests).

    Returns ``(lik, scaler)``: ``(n_pad,)`` fp32 and int32.
    """
    if not interpret and jax.default_backend() != "gpu":
        raise ValueError(
            "the Triton tree kernel compiles only for a GPU backend "
            f"(this one is {jax.default_backend()!r}); pass "
            "interpret=True to run it in the Pallas interpreter")
    n_leaves, n_pad = codes.shape
    if block_sites is None:
        block_sites = choose_block(n_pad)
    if n_pad % block_sites or block_sites & (block_sites - 1):
        raise ValueError(f"block_sites={block_sites} must be a power of "
                         f"two dividing n_pad={n_pad}")
    arrs, n_slots, root_slot = compile_register_schedule(schedule, n_leaves)
    lsrc, lflag, rsrc, rflag, oslot, _edge = arrs
    sched = tuple(jnp.asarray(a) for a in (lsrc, lflag, rsrc, rflag, oslot)
                  ) + (jnp.asarray([root_slot], jnp.int32),)
    return _tree_call(sched, codes, ops, ev, tip_table, root_rows, n,
                      n_slots=n_slots, block_sites=int(block_sites),
                      interpret=interpret)
