"""Whole-tree traversals in plain JAX.

* :func:`traverse` unrolls a post-order schedule at trace time into one
  XLA program: every internal CLV is one fused node op (plf_xla.plf_node)
  that XLA writes to and re-reads from device memory.  It is the
  reference traversal, the one the gradients differentiate, and the
  fallback wherever the whole-tree kernel (ops/tree_triton.py) does not
  apply.
* :func:`traverse_dynamic` runs the schedule as DATA: a ``fori_loop``
  over register-machine arrays (ops/schedule.compile_register_schedule)
  with dynamic indices into a slot arena in device memory.  One
  compilation serves every topology with the same edge and slot count,
  which is what tree search needs; :func:`batch_loglik_parts` vmaps it
  over candidate chunks sized to device memory.

Tip CLVs are never stored: a leaf's int8/int32 state codes gather its
eigen-coordinate CLV from the ``(S, ncode)`` tip table at the point of
use (exact: a gather, no arithmetic).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from .plf_xla import plf_node

__all__ = ["expand_tips", "traverse", "traverse_dynamic",
           "batch_loglik_parts", "batch_chunk"]

LOG_MINLIK = float(np.log(np.float64(2.0) ** -32))
LIK_FLOOR = 1.1754944e-38     # FLT_MIN: survives flush-to-zero


def expand_tips(codes, tip_table):
    """``(..., n)`` int codes -> ``(S, ..., n)`` fp32 tip CLVs."""
    return jnp.take(tip_table, codes.astype(jnp.int32), axis=1,
                    mode="clip")


def traverse(codes, lops, rops, ev, tip_table, root_rows, n, *,
             schedule, n_leaves, variant="vpu", dtype=jnp.float32):
    """Unrolled post-order traversal.

    Args:
      codes: ``(n_leaves, n_pad)`` int tip codes.
      lops, rops: ``(E, C, S, S)`` branch matrices of each entry's left
        and right child, in ``schedule`` order.
      ev: ``(S, S)`` eigenvector matrix.
      tip_table: ``(S, ncode)`` eigen-coordinate tip CLV per code.
      root_rows: ``(S, C)`` root weights, ``pi^T U`` times the category
        mixture weights.
      n: valid site count.
      schedule: static tuple of ``(parent, left, right)``.
      dtype: storage of the intermediate CLVs (fp32, or bf16 fast mode).

    Returns ``(lik, scaler, x_root)``: ``(n_pad,)`` fp32 per-site
    likelihood before the log, ``(n_pad,)`` int32 rescale counts and the
    ``(S, C, n_pad)`` root CLV.
    """
    n_pad = codes.shape[-1]
    valid = jnp.arange(n_pad) < n
    clvs = {}
    scaler = jnp.zeros((n_pad,), jnp.int32)
    for e, (parent, l, r) in enumerate(schedule):
        x1, x2 = [expand_tips(codes[ch], tip_table)[:, None, :]
                  if ch < n_leaves else clvs.pop(ch) for ch in (l, r)]
        x3, mask = plf_node(x1, x2, lops[e], rops[e], ev, valid, variant)
        clvs[parent] = x3.astype(dtype)
        scaler = scaler + mask
    x_root = clvs[schedule[-1][0]].astype(jnp.float32)
    lik = jnp.sum(root_rows[:, :, None] * x_root, axis=(0, 1))
    return lik, scaler, x_root


def traverse_dynamic(tips, lops, rops, ev, root_rows, valid, sched, *,
                     n_slots, variant="vpu", dtype=jnp.float32):
    """Register-machine traversal with the schedule as data.

    ``tips``: ``(n_leaves, S, n_pad)`` expanded tip CLVs (shared by every
    topology over one alignment); ``sched``: the int32 arrays (lsrc,
    lflag, rsrc, rflag, oslot) of length E plus the root slot;
    ``lops``/``rops``: ``(E, C, S, S)`` in schedule order.

    Returns ``(lik, scaler)`` as :func:`traverse`.
    """
    lsrc, lflag, rsrc, rflag, oslot, root_slot = sched
    S, C = ev.shape[0], lops.shape[1]
    n_pad = tips.shape[-1]
    take = functools.partial(jax.lax.dynamic_index_in_dim, keepdims=False)

    def body(i, carry):
        slots, scaler = carry

        def operand(src, flag):
            # a leaf index may exceed the slot count and the converse;
            # dynamic indices clamp, and the flag picks the real one
            return jnp.where(flag == 1, take(slots, src).astype(jnp.float32),
                             take(tips, src)[:, None, :])

        x3, mask = plf_node(operand(lsrc[i], lflag[i]),
                            operand(rsrc[i], rflag[i]),
                            take(lops, i), take(rops, i), ev, valid,
                            variant)
        slots = jax.lax.dynamic_update_index_in_dim(
            slots, x3.astype(dtype), oslot[i], 0)
        return slots, scaler + mask

    slots0 = jnp.zeros((n_slots, S, C, n_pad), dtype)
    slots, scaler = jax.lax.fori_loop(
        0, lsrc.shape[0], body, (slots0, jnp.zeros((n_pad,), jnp.int32)))
    x_root = take(slots, root_slot).astype(jnp.float32)
    lik = jnp.sum(root_rows[:, :, None] * x_root, axis=(0, 1))
    return lik, scaler


def batch_chunk(n_candidates: int, n_slots: int, rows: int, n_pad: int,
                budget_bytes: int) -> int:
    """Candidates per vmapped chunk: the slot arenas plus the node op's
    temporaries (about six CLVs) of each candidate within ``budget``."""
    per = (n_slots + 6) * rows * n_pad * 4
    return int(max(1, min(n_candidates, budget_bytes // per)))


@functools.partial(jax.jit, static_argnames=("n_slots", "n_parts", "chunk",
                                             "variant", "dtype"))
def batch_loglik_parts(codes, tip_table, lops_b, rops_b, sched_b, ev,
                       root_rows, wgt, n, *, n_slots, n_parts, chunk,
                       variant="vpu", dtype=jnp.float32):
    """Score B same-shape topologies over one alignment in one program.

    ``lops_b``/``rops_b``: ``(B, E, C, S, S)``; ``sched_b``: the six
    register arrays, each with a leading B axis; ``wgt``: ``(n_pad,)``
    fp32 site weights (zero on padding).  B must be a multiple of
    ``chunk``: a ``lax.map`` walks the chunks, a ``vmap`` the candidates
    of one chunk.

    Returns ``(B, n_parts)`` fp32 partial sums of the weighted per-site
    log-likelihood with the rescale counts folded in; sum them on the
    host in float64.
    """
    n_pad = codes.shape[-1]
    valid = jnp.arange(n_pad) < n
    tips = jnp.moveaxis(expand_tips(codes, tip_table), 0, 1)

    def one(lops, rops, sched):
        lik, sc = traverse_dynamic(tips, lops, rops, ev, root_rows, valid,
                                   sched, n_slots=n_slots, variant=variant,
                                   dtype=dtype)
        site = (jnp.log(jnp.maximum(lik, jnp.float32(LIK_FLOOR)))
                + sc.astype(jnp.float32) * jnp.float32(LOG_MINLIK)) * wgt
        return jnp.sum(site.reshape(n_parts, -1), axis=-1)

    def by_chunk(x):
        return x.reshape((-1, chunk) + x.shape[1:])

    xs = jax.tree.map(by_chunk, (lops_b, rops_b, sched_b))
    parts = jax.lax.map(lambda a: jax.vmap(one)(*a), xs)
    return parts.reshape(-1, n_parts)
