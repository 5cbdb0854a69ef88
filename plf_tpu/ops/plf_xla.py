"""The PLF node in plain JAX on the lane-major CLV layout.

A CLV is held lane-major as ``(S*C, n)`` with row ``a*C + c``
(ops/layout.py); inside this module it is viewed as ``(S, C, n)``.  One
node combines two child CLVs through per-category branch matrices
``B[c, k, a]`` and projects through the eigenvector matrix ``EV[k, a]``
(the reference's ``newviewGAMMA`` stages, app/src/plf.cpp:29-64):

  stage 1:  ump[k, c] = sum_a B[c, k, a] * x[a, c]        (each child)
  stage 2:  p = ump_left * ump_right
  stage 3:  x3[a, c]  = sum_k EV[k, a] * p[k, c]
  stage 4:  x3 *= 2^32 where max over rows |x3| < 2^-32 (valid sites)

``variant`` chooses how stages 1 and 3 are computed:

* ``"vpu"`` — sequential element-wise sums in the golden model's order.
  XLA fuses the node into one loop over sites: two CLV reads and one
  write, about 1.9 FLOP per byte.
* ``"mxu"``, ``"mxu_3x"``, ``"mxu_bf16"`` — per-category batched dots
  ``(C, S, S) @ (C, S, n)`` at the dot algorithm named in
  :data:`DOT_ALGORITHM` (the form for S >= 20, where the dots carry the
  FLOPs).  Naming the algorithm keeps an fp32 dot out of TF32 on GPUs.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from ..reference import MIN_LIKELIHOOD, TWO_TO_THE_32
from . import layout as L

__all__ = ["DOT_ALGORITHM", "plf_node", "plf_lane_major", "plf_xla"]

#: Kernel variant -> dot algorithm of stages 1 and 3.
DOT_ALGORITHM = {
    "mxu": jax.lax.DotAlgorithmPreset.F32_F32_F32,
    "mxu_3x": jax.lax.DotAlgorithmPreset.BF16_BF16_F32_X3,
    "mxu_bf16": jax.lax.DotAlgorithmPreset.BF16_BF16_F32,
}


def plf_node(x1, x2, left, right, ev, valid=None, variant: str = "vpu"):
    """One PLF node on ``(S, C, n)`` CLVs.

    ``x1``/``x2`` may have a category axis of 1 (a tip CLV, which is the
    same for every category).  ``left``/``right``: ``(C, S, S)`` branch
    matrices ``[c, k, a]``; ``ev``: ``(S, S)`` ``[k, a]``; ``valid``:
    ``(n,)`` bool, sites that may count a rescale.

    Returns ``(x3, mask)``: ``(S, C, n)`` fp32 and ``(n,)`` int32.
    """
    S = ev.shape[0]
    C = left.shape[0]
    x1 = x1.astype(jnp.float32)
    x2 = x2.astype(jnp.float32)
    if variant == "vpu":
        def stage1(b, x):
            bt = jnp.transpose(b, (2, 1, 0))[:, :, :, None]   # [a, k, c, 1]
            u = bt[0] * x[0][None]
            for a in range(1, S):
                u = u + bt[a] * x[a][None]
            return u                                         # (S, C, n)

        p = stage1(left, x1) * stage1(right, x2)
        x3 = ev[0][:, None, None] * p[0][None]
        for k in range(1, S):
            x3 = x3 + ev[k][:, None, None] * p[k][None]
    else:
        alg = DOT_ALGORITHM[variant]
        n = x1.shape[-1]

        def stage1(b, x):
            x = jnp.broadcast_to(x, (S, C, n))
            return jnp.einsum("cka,acn->kcn", b, x, precision=alg)

        p = stage1(left, x1) * stage1(right, x2)
        x3 = jnp.einsum("ka,kcn->acn", ev, p, precision=alg)
    mask = jnp.max(jnp.abs(x3), axis=(0, 1)) < MIN_LIKELIHOOD
    if valid is not None:
        mask = jnp.logical_and(mask, valid)
    x3 = jnp.where(mask, x3 * TWO_TO_THE_32, x3)
    return x3, mask.astype(jnp.int32)


@functools.partial(jax.jit,
                   static_argnames=("states", "categories", "variant"))
def plf_lane_major(x1, x2, left, right, ev, n, *, states: int = 4,
                   categories: int = 4, variant: str = "vpu"):
    """PLF on lane-major ``(S*C, n_pad)`` operands.

    ``left``/``right``: ``(C, S, S)``; ``ev``: ``(S, S)``; ``n``: count
    of valid sites (padding beyond it never counts a rescale).  The
    output CLV keeps the input dtype (fp32, or bf16 storage); arithmetic
    is fp32.

    Returns ``(x3, scaler)``: ``(S*C, n_pad)`` and ``(n_pad,)`` int32.
    """
    S, C = states, categories
    n_pad = x1.shape[-1]
    valid = jnp.arange(n_pad) < n
    x3, mask = plf_node(
        x1.reshape(S, C, n_pad), x2.reshape(S, C, n_pad),
        jnp.asarray(left, jnp.float32).reshape(C, S, S),
        jnp.asarray(right, jnp.float32).reshape(C, S, S),
        jnp.asarray(ev, jnp.float32).reshape(S, S), valid, variant)
    return x3.reshape(S * C, n_pad).astype(x1.dtype), mask


def plf_xla(x1, x2, left, right, ev, wgt, states: int = 4,
            categories: int = 4, variant: str = "vpu",
            dtype: str = "float32"):
    """PLF over a site-major batch (the golden model's signature).

    Args:
      x1, x2: ``(n, C*S)`` or ``(n, C, S)`` child CLVs.
      left, right: ``(C, S, S)`` branch matrices ``[c, k, a]``.
      ev: ``(S, S)`` eigenvector matrix ``[k, a]``.
      wgt: ``(n,)`` int32 site weights.
      dtype: CLV storage of the operands and the result ("float32" or
        "bfloat16"); arithmetic is fp32 either way.

    Returns:
      ``(x3, scaler_vector, scaler_increment)``: ``(n, C, S)``, ``(n,)``
      int32 in {0, 1}, and the weighted scaler sum.
    """
    S, C = states, categories
    n = jnp.asarray(x1).reshape(-1, C, S).shape[0]
    x1l = L.to_lane_major(jnp.asarray(x1), S, C).astype(dtype)
    x2l = L.to_lane_major(jnp.asarray(x2), S, C).astype(dtype)
    x3l, sv = plf_lane_major(x1l, x2l, left, right, ev, n, states=S,
                             categories=C, variant=variant)
    x3 = L.from_lane_major(x3l, S, C)
    inc = jnp.sum(sv * jnp.asarray(wgt, jnp.int32))
    return x3, sv, inc
