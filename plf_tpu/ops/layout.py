"""CLV memory layouts and the padding policy.

Two layouts exist in the framework:

* **site-major** ``(n, categories*states)`` — the RAxML/host layout
  (``clv[site*16 + cat*4 + state]``, app/src/plf.cpp:21-23).  This is the
  user-facing import/export format.

* **lane-major** ``(states*categories, n)`` with row index
  ``r = state*categories + cat`` — the canonical on-device layout.  Sites
  are the minor (contiguous) axis, so every stage of the node op streams
  whole rows of sites and needs no transpose; viewed as ``(S, C, n)`` the
  stages are broadcasts over sites (ops/plf_xla.py).  This is the analogue
  of the reference PL's 4-lane split of each 512-bit site record across
  PLIO streams (hls/src/mm2sleft_memDNAwindowComb.cpp:86-96) — there a lane
  owned one rate category; here a row owns one (state, category) pair and
  the minor axis owns sites.

Padding: site counts are padded up to a multiple of ``block_sites`` (the
"window" analogue) exactly like the reference pads the last instance /
window (app/src/include.h:181-195, 262-266); padded sites never count a
rescale (s2mm_memDNAwindowComb.cpp:79 semantics).
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

__all__ = [
    "cdiv", "pad_to_multiple", "sites_padding",
    "to_lane_major", "from_lane_major",
]


def cdiv(a: int, b: int) -> int:
    return -(-a // b)


def sites_padding(n: int, block: int) -> int:
    """Padded site count (ceil to block multiple), min one block."""
    return max(block, cdiv(n, block) * block)


def pad_to_multiple(x, block: int, axis: int = -1):
    """Zero-pad ``x`` along ``axis`` up to a multiple of ``block``."""
    n = x.shape[axis]
    target = sites_padding(n, block)
    if target == n:
        return x
    pads = [(0, 0)] * x.ndim
    pads[axis] = (0, target - n)
    if isinstance(x, np.ndarray):
        return np.pad(x, pads)
    return jnp.pad(x, pads)


def to_lane_major(clv, states: int = 4, categories: int = 4):
    """site-major ``(n, C*S)`` or ``(n, C, S)`` -> lane-major ``(S*C, n)``.

    Row order is state-major: ``row = state*C + cat``.
    """
    xp = np if isinstance(clv, np.ndarray) else jnp
    S, C = states, categories
    x = clv.reshape(-1, C, S)           # (n, c, a)
    x = xp.transpose(x, (2, 1, 0))      # (a, c, n)
    return x.reshape(S * C, -1)         # row = a*C + c


def from_lane_major(x, states: int = 4, categories: int = 4, n=None):
    """lane-major ``(S*C, n_pad)`` -> site-major ``(n, C, S)``."""
    xp = np if isinstance(x, np.ndarray) else jnp
    S, C = states, categories
    y = x.reshape(S, C, -1)
    y = xp.transpose(y, (2, 1, 0))      # (n_pad, c, a)
    if n is not None:
        y = y[:n]
    return y
