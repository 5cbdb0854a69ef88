"""Multi-chip site-sharded PLF: the scale-out layer.

The reference's only parallelism across "devices" is splitting the site
dimension over up to 9 accelerator instances with ceil-div partitioning and
last-instance padding (app/src/include.h:181-195), replicating the 80-float
EV+branch header to every instance (host_mem.cpp:229-241), and reducing the
weighted scaler counts on the host (host_mem.cpp:385-388).  Its README
names multi-instance site-sharding the roadmap item (README.md:201-205).

Here: a 1-D ``sites`` mesh axis over all devices (every card of a host
reaches every other, so the mesh follows the algorithm alone),
``shard_map`` over per-device lane-major CLV shards,
replicated branch/EV constants, and a ``psum`` for the scaler reduction.
The site axis is pointwise — no halo, no resharding — so weak scaling is
limited only by the psum latency (a single int32).
"""

from __future__ import annotations

import functools
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..ops import layout as L
from ..ops.plf_xla import plf_lane_major

__all__ = ["make_mesh", "shard_sites", "plf_sharded", "ShardedPLF"]


def make_mesh(n_devices: Optional[int] = None, axis: str = "sites") -> Mesh:
    """1-D device mesh over the site axis."""
    devs = jax.devices()
    if n_devices is not None:
        devs = devs[:n_devices]
    return Mesh(np.asarray(devs), (axis,))


def shard_sites(mesh: Mesh, x, axis: str = "sites"):
    """Place a lane-major array with its last axis sharded over the mesh."""
    spec = P(*([None] * (x.ndim - 1) + [axis]))
    return jax.device_put(x, NamedSharding(mesh, spec))


@functools.partial(
    jax.jit,
    static_argnames=("mesh", "states", "categories", "block_sites",
                     "variant", "axis"))
def plf_sharded(x1, x2, lc, rc, ec, wgt, n, *, mesh: Mesh, states: int = 4,
                categories: int = 4, block_sites: int = 1024,
                variant: str = "vpu", axis: str = "sites"):
    """Site-sharded PLF over a device mesh.

    Args:
      x1, x2: ``(S*C, n_pad)`` lane-major CLVs; ``n_pad`` must be a multiple
        of ``n_devices * block_sites`` (use :func:`padded_sites`).
      lc, rc, ec: ``(C, S, S)`` branch matrices and the ``(S, S)``
        eigenvector matrix (replicated).
      wgt: ``(1, n_pad)`` int32 site weights (sharded with the sites; pad
        with zeros).
      n: scalar int32 count of valid sites (global).

    Returns:
      ``(x3, scaler, scaler_increment)`` — x3 ``(S*C, n_pad)`` and scaler
      ``(n_pad,)`` sharded like the inputs, scaler_increment a replicated
      scalar (psum over shards).
    """
    ndev = mesh.shape[axis]
    n_pad = x1.shape[-1]
    if n_pad % (ndev * block_sites):
        raise ValueError(
            f"padded sites {n_pad} not divisible by devices*block "
            f"({ndev}*{block_sites})")
    shard = n_pad // ndev

    def local(x1s, x2s, lcs, rcs, ecs, wgts, ns):
        # Global->local site index offset for the padding/validity guard:
        # this shard owns sites [rank*shard, (rank+1)*shard).  Sites with
        # local_idx >= n_local never count a rescale (reference
        # last-instance padding, include.h:181-195).
        rank = jax.lax.axis_index(axis)
        n_local = jnp.clip(ns - rank * shard, 0, shard)
        x3s, scs = plf_lane_major(
            x1s, x2s, lcs, rcs, ecs, n_local, states=states,
            categories=categories, variant=variant)
        inc = jnp.sum(scs * wgts[0].astype(jnp.int32))
        inc = jax.lax.psum(inc, axis)
        return x3s, scs, inc

    spec_data = P(None, axis)
    fn = jax.shard_map(
        local, mesh=mesh,
        in_specs=(spec_data, spec_data, P(), P(), P(), spec_data, P()),
        out_specs=(spec_data, P(axis), P()),
    )
    return fn(x1, x2, lc, rc, ec, wgt, jnp.asarray(n, jnp.int32))


class ShardedPLF:
    """Convenience wrapper owning mesh + constants for repeated calls.

    Typical use: CLVs live device-resident and lane-major for a whole tree
    traversal; only branch matrices change per call.
    """

    def __init__(self, mesh: Optional[Mesh] = None, states: int = 4,
                 categories: int = 4, block_sites: int = 1024,
                 variant: str = "vpu"):
        self.mesh = mesh or make_mesh()
        self.states = states
        self.categories = categories
        self.block_sites = block_sites
        self.variant = variant

    @property
    def n_devices(self) -> int:
        return self.mesh.shape["sites"]

    def padded_sites(self, n: int) -> int:
        """Global padded site count: ceil to devices*block (the multi-
        instance ceil-div+window-rounding policy, include.h:181-195,262-266)."""
        unit = self.n_devices * self.block_sites
        return max(unit, L.cdiv(n, unit) * unit)

    def prepare(self, clv_site_major, n: Optional[int] = None):
        """site-major host CLV -> padded lane-major sharded device array."""
        S, C = self.states, self.categories
        x = L.to_lane_major(clv_site_major, S, C)
        n = x.shape[-1] if n is None else n
        x = L.pad_to_multiple(x, self.padded_sites(n), axis=-1)
        return shard_sites(self.mesh, jnp.asarray(x))

    def prepare_weights(self, wgt, n: Optional[int] = None):
        w = np.asarray(wgt, np.int32).reshape(1, -1)
        n = w.shape[-1] if n is None else n
        w = L.pad_to_multiple(w, self.padded_sites(n), axis=-1)
        return shard_sites(self.mesh, jnp.asarray(w))

    def constants(self, left, right, ev):
        """Branch and eigenvector matrices, replicated on every device."""
        S, C = self.states, self.categories
        rep = NamedSharding(self.mesh, P())

        def put(x, shape):
            return jax.device_put(np.asarray(x, np.float32).reshape(shape),
                                  rep)
        return put(left, (C, S, S)), put(right, (C, S, S)), put(ev, (S, S))

    def __call__(self, x1, x2, lc, rc, ec, wgt, n):
        return plf_sharded(
            x1, x2, lc, rc, ec, wgt, n, mesh=self.mesh, states=self.states,
            categories=self.categories, block_sites=self.block_sites,
            variant=self.variant)
