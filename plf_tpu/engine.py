"""High-level PLF engine: the device replacement for the reference host runtime.

The reference host program (app/src/host_mem.cpp:11-547) owns: config
resolution, buffer geometry, instance partitioning, kernel dispatch, the
scaler reduction, and golden verification.  Here that becomes a small
stateful :class:`PLFEngine` over pure jitted functions:

* ``plf()``           — one PLF call (site batch -> parent CLV + scalers)
* ``plf_batch()``     — N independent node-pairs at once (the reference's
                        9-accelerator multi-instance mode, vmapped)
* ``verify()``        — golden-model comparison with the reference's
                        float-equality criterion (host_mem.cpp:403-442)

CLVs stay device-resident between calls (the reference pays PCIe per call —
its own README names that the main bottleneck, README.md:204).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from .config import Backend, PLFConfig
from .ops.plf_xla import plf_lane_major, plf_xla
from .reference import plf_reference

__all__ = ["PLFEngine", "PLFResult", "plf"]


@dataclasses.dataclass
class PLFResult:
    """Outputs of one PLF call (mirrors the reference's out + scaler bos)."""

    x3: jax.Array               # (n, C, S) parent CLV
    scaler_vector: jax.Array    # (n,) int32 per-site rescale flags
    scaler_increment: jax.Array  # () int32 weighted sum (host_mem.cpp:385-388)


class PLFEngine:
    """Configured PLF evaluator.

    Example::

        eng = PLFEngine(PLFConfig(states=4, block_sites=4096))
        out = eng.plf(x1, x2, left, right, ev, wgt)
    """

    def __init__(self, config: Optional[PLFConfig] = None):
        self.config = config or PLFConfig()

    # -- geometry / config report (testbench_info + host_mem.cpp:45-101) ----

    def geometry(self, n_sites: int, plf_calls: int = 1) -> dict:
        """Buffer geometry for a workload — the testbench_info oracle
        (include.h:150-268) recast for HBM-resident lane-major buffers."""
        cfg = self.config
        from .ops import layout as L
        e = cfg.elements_per_site
        n_pad = L.sites_padding(n_sites, cfg.block_sites)
        clv_bytes = e * 4 * n_pad
        scaler_bytes = 4 * n_pad
        const_bytes = (2 * cfg.rows * cfg.states + cfg.rows * cfg.states) * 4
        per_call = dict(
            sites=n_sites, sites_padded=n_pad,
            padding=n_pad - n_sites,
            elements_per_site=e,
            clv_bytes=clv_bytes,
            input_bytes=2 * clv_bytes + const_bytes,
            output_bytes=clv_bytes + scaler_bytes,
            blocks=n_pad // cfg.block_sites,
        )
        per_call["hbm_bytes"] = (per_call["input_bytes"]
                                 + per_call["output_bytes"])
        return dict(per_call=per_call, instances=cfg.instances,
                    plf_calls=plf_calls,
                    total_sites=n_sites * plf_calls * cfg.instances,
                    total_hbm_bytes=per_call["hbm_bytes"] * cfg.instances)

    def describe(self, n_sites: int, plf_calls: int = 1) -> str:
        """Reference-style config/geometry report (host_mem.cpp:45-101)."""
        cfg = self.config
        g = self.geometry(n_sites, plf_calls)
        p = g["per_call"]
        bar = "=" * 68
        rows = [
            bar,
            f"| {'config name':24} | {cfg.to_name():36} |",
            f"| {'backend':24} | {cfg.backend.value:36} |",
            f"| {'states x categories':24} | "
            f"{f'{cfg.states} x {cfg.categories}':36} |",
            f"| {'block sites (window)':24} | {cfg.block_sites:36} |",
            bar,
            f"| {'alignment sites':24} | {n_sites:36} |",
            f"| {'padded sites':24} | {p['sites_padded']:36} |",
            f"| {'plf calls':24} | {plf_calls:36} |",
            f"| {'instances':24} | {cfg.instances:36} |",
            bar,
            f"| {'CLV bytes (each)':24} | {p['clv_bytes']:36} |",
            f"| {'HBM bytes per call':24} | {p['hbm_bytes']:36} |",
            f"| {'grid blocks':24} | {p['blocks']:36} |",
            bar,
        ]
        return "\n".join(rows)

    # -- single call ---------------------------------------------------------

    def plf(self, x1, x2, left, right, ev, wgt=None) -> PLFResult:
        cfg = self.config
        S, C = cfg.states, cfg.categories
        n = np.asarray(x1).reshape(-1, C, S).shape[0] if isinstance(
            x1, np.ndarray) else x1.reshape(-1, C, S).shape[0]
        if wgt is None:
            wgt = jnp.ones((n,), dtype=jnp.int32)
        if cfg.backend is Backend.REFERENCE:
            x3, sv, si = plf_reference(
                np.asarray(x1), np.asarray(x2), np.asarray(left),
                np.asarray(right), np.asarray(ev), np.asarray(wgt),
                states=S, categories=C)
            return PLFResult(jnp.asarray(x3), jnp.asarray(sv.astype(np.int32)),
                             jnp.asarray(si, dtype=jnp.int32))
        x3, sv, si = plf_xla(x1, x2, left, right, ev, wgt, states=S,
                             categories=C,
                             variant=cfg.resolved_kernel_variant,
                             dtype=cfg.dtype)
        return PLFResult(x3, sv, si)

    # -- multi-instance (the 9-accelerator analogue) -------------------------

    def plf_batch(self, x1, x2, left, right, ev, wgt=None) -> PLFResult:
        """Evaluate ``I`` independent node-pairs in one dispatch.

        Args are batched on a leading instance axis: ``x1/x2`` of shape
        ``(I, n, C*S)`` (or ``(I, n, C, S)``), ``left/right`` ``(I, C, S, S)``,
        ``ev`` ``(I, S, S)`` (the reference replicates one EV to all
        instances — pass broadcasted).  Equivalent of NUM_ACCELERATORS=9
        (Makefile:29): the instances dimension is batch work for one
        vmapped program, no separate hardware contexts needed.
        """
        cfg = self.config
        S, C = cfg.states, cfg.categories
        x1 = jnp.asarray(x1)
        ni = x1.shape[0]
        n = x1.reshape(ni, -1, C, S).shape[1]
        if wgt is None:
            wgt = jnp.ones((ni, n), dtype=jnp.int32)

        def lane(x):        # (I, n, C, S) -> (I, S*C, n), row a*C + c
            x = jnp.asarray(x).reshape(ni, n, C, S)
            return jnp.transpose(x, (0, 3, 2, 1)).reshape(ni, S * C, n)

        def one(a, b, l, r, e):
            return plf_lane_major(a, b, l, r, e, n, states=S, categories=C,
                                  variant=cfg.resolved_kernel_variant)

        x3l, sv = jax.vmap(one)(lane(x1).astype(cfg.dtype),
                                lane(x2).astype(cfg.dtype),
                                jnp.asarray(left, jnp.float32),
                                jnp.asarray(right, jnp.float32),
                                jnp.asarray(ev, jnp.float32))
        x3 = jnp.transpose(x3l.reshape(ni, S, C, n), (0, 3, 2, 1))
        si = jnp.sum(sv * jnp.asarray(wgt, jnp.int32), axis=-1)
        return PLFResult(x3, sv, si)

    # -- verification (host_mem.cpp:403-442 semantics) -----------------------

    def verify(self, result: PLFResult, x1, x2, left, right, ev, wgt=None,
               max_errors: int = 20, exact: Optional[bool] = None):
        """Golden-model check; returns (ok, n_errors, messages).

        ``exact=True`` applies the reference's bit-exact float equality
        criterion (host_mem.cpp:423).  The default follows the path: the
        NumPy golden backend is exact; the XLA paths let the compiler
        contract mul+add into FMA (on the CPU and the GPU alike), so their
        bar is a relative 5e-7 (a few ULP) per CLV element.
        """
        cfg = self.config
        if exact is None:
            exact = cfg.backend is Backend.REFERENCE
        x3_ref, sv_ref, si_ref = plf_reference(
            np.asarray(x1), np.asarray(x2), np.asarray(left),
            np.asarray(right), np.asarray(ev),
            None if wgt is None else np.asarray(wgt),
            states=cfg.states, categories=cfg.categories)
        got = np.asarray(result.x3).reshape(x3_ref.shape)
        if exact:
            neq = got != x3_ref
        else:
            tol = np.abs(x3_ref) * np.float32(5e-7) + np.float32(1e-37)
            neq = np.abs(got - x3_ref) > tol
        msgs = []
        if neq.any():
            idx = np.argwhere(neq)
            for site, c, a in idx[:max_errors]:
                msgs.append(
                    f"ERROR: alignment data wrong at alignment {site}, "
                    f"probability {c * cfg.states + a}, "
                    f"cpu!=device: {x3_ref[site, c, a]}!={got[site, c, a]}")
        n_errors = int(neq.sum())
        si_got = int(np.asarray(result.scaler_increment))
        if si_got != si_ref:
            msgs.append(f"ERROR: scalerIncrement wrong, cpu!=device: "
                        f"{si_ref}!={si_got}")
            n_errors += 1
        return n_errors == 0, n_errors, msgs


def plf(x1, x2, left, right, ev, wgt=None, config: Optional[PLFConfig] = None):
    """Functional one-shot PLF with a default engine."""
    return PLFEngine(config).plf(x1, x2, left, right, ev, wgt)
