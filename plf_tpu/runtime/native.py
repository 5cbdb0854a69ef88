"""ctypes bindings to the native runtime library (libplf_native.so).

The native layer supplies: a fast bit-exact golden oracle (single- and
multi-threaded — the reference recomputes every benchmark workload on one
CPU thread, host_mem.cpp:403-442; ours threads it), lane-layout
converters, and reference-format instance buffer packers.  It is built
from ``plf_tpu/native/plf_native.cpp`` on first use with ``make`` (g++,
-ffp-contract=off) into ``plf_tpu/native/build/``, which git ignores;
every entry point has a NumPy fallback so the package works without a
toolchain.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
from typing import Optional

import numpy as np

_NATIVE_DIR = os.path.abspath(
    os.path.join(os.path.dirname(__file__), "..", "native"))
_LIB_PATH = os.path.join(_NATIVE_DIR, "build", "libplf_native.so")

_lib: Optional[ctypes.CDLL] = None
_build_attempted = False


def _f32p(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def build_native(force: bool = False) -> bool:
    """Compile the library from the committed source; returns success.

    Always invokes ``make``, which rebuilds when the source is newer
    than the library (``-B`` with ``force``).
    """
    global _build_attempted
    _build_attempted = True
    try:
        subprocess.run(["make", "-C", _NATIVE_DIR]
                       + (["-B"] if force else []),
                       check=True, capture_output=True, timeout=120)
    except Exception:
        return False
    return os.path.exists(_LIB_PATH)


def load_native() -> Optional[ctypes.CDLL]:
    """Load (building if needed) the native library; None if unavailable."""
    global _lib
    if _lib is not None:
        return _lib
    if not _build_attempted:
        build_native()   # no-op when the .so is fresh; rebuilds if stale
    if not os.path.exists(_LIB_PATH):
        return None
    lib = ctypes.CDLL(_LIB_PATH)
    ll, i32, u8p, i32p = (ctypes.c_longlong, ctypes.c_int,
                          ctypes.POINTER(ctypes.c_ubyte),
                          ctypes.POINTER(ctypes.c_int))
    fp = ctypes.POINTER(ctypes.c_float)
    lib.plf_golden.restype = ll
    lib.plf_golden.argtypes = [fp, fp, fp, fp, ll, fp, fp, i32p, u8p,
                               i32, i32]
    lib.plf_golden_mt.restype = ll
    lib.plf_golden_mt.argtypes = [fp, fp, fp, fp, ll, fp, fp, i32p, u8p,
                                  i32, i32, i32]
    lib.to_lane_major.restype = None
    lib.to_lane_major.argtypes = [fp, fp, ll, i32, i32]
    lib.from_lane_major.restype = None
    lib.from_lane_major.argtypes = [fp, fp, ll, ll, i32, i32]
    lib.pack_instance.restype = ll
    lib.pack_instance.argtypes = [fp, fp, fp, fp, ll, i32, i32, i32]
    lib.unpack_instance.restype = ll
    lib.unpack_instance.argtypes = [fp, fp, fp, fp, ll, i32, i32, i32]
    lib.transpose_branch.restype = None
    lib.transpose_branch.argtypes = [fp, fp, i32, i32]
    i32arr = ctypes.POINTER(ctypes.c_int32)
    try:   # absent in pre-v2 builds of the .so (rebuild handles it)
        lib.plf_tree_golden_mt.restype = None
        lib.plf_tree_golden_mt.argtypes = [
            i32arr, ll, i32, fp, i32, i32arr, i32arr, i32arr, i32, i32,
            fp, fp, fp, fp, i32, i32, fp, i32arr, i32]
    except AttributeError:
        pass
    _lib = lib
    return lib


def native_available() -> bool:
    return load_native() is not None


def plf_golden_native(x1, x2, left, right, ev, wgt=None, states=4,
                      categories=4, threads: Optional[int] = None):
    """Native golden PLF; same contract as reference.plf_reference.

    Falls back to the NumPy golden model when the library is missing.
    """
    lib = load_native()
    S, C = states, categories
    e = S * C
    x1 = np.ascontiguousarray(np.asarray(x1, np.float32).reshape(-1, e))
    x2 = np.ascontiguousarray(np.asarray(x2, np.float32).reshape(-1, e))
    n = x1.shape[0]
    if lib is None:
        from ..reference import plf_reference
        x3, sv, inc = plf_reference(x1, x2, left, right, ev, wgt,
                                    states=S, categories=C)
        return x3, sv, inc
    left = np.ascontiguousarray(np.asarray(left, np.float32).reshape(-1))
    right = np.ascontiguousarray(np.asarray(right, np.float32).reshape(-1))
    ev = np.ascontiguousarray(np.asarray(ev, np.float32).reshape(-1))
    if wgt is None:
        wgt = np.ones((n,), np.int32)
    wgt = np.ascontiguousarray(np.asarray(wgt, np.int32))
    x3 = np.empty((n, e), np.float32)
    scaler = np.empty((n,), np.uint8)
    if threads is None:
        threads = min(os.cpu_count() or 1, 16)
    inc = lib.plf_golden_mt(
        _f32p(x1), _f32p(x2), _f32p(x3), _f32p(ev), n, _f32p(left),
        _f32p(right), wgt.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
        scaler.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte)), S, C,
        int(threads))
    return x3.reshape(n, C, S), scaler, int(inc)


def to_lane_major_native(clv, states=4, categories=4):
    """Native site-major -> lane-major; NumPy fallback."""
    lib = load_native()
    S, C = states, categories
    clv = np.ascontiguousarray(
        np.asarray(clv, np.float32).reshape(-1, C * S))
    n = clv.shape[0]
    if lib is None:
        from ..ops.layout import to_lane_major
        return to_lane_major(clv, S, C)
    out = np.empty((S * C, n), np.float32)
    lib.to_lane_major(_f32p(clv), _f32p(out), n, S, C)
    return out


def from_lane_major_native(x, n=None, states=4, categories=4):
    """Native lane-major -> site-major; NumPy fallback."""
    lib = load_native()
    S, C = states, categories
    x = np.ascontiguousarray(np.asarray(x, np.float32))
    n_pad = x.shape[-1]
    n = n_pad if n is None else n
    if lib is None:
        from ..ops.layout import from_lane_major
        return from_lane_major(x, S, C, n=n)
    out = np.empty((n, C * S), np.float32)
    lib.from_lane_major(_f32p(x), _f32p(out), n, n_pad, S, C)
    return out.reshape(n, C, S)


def pack_instance_native(ev, branch, clv, states=4, categories=4,
                         combined=True):
    """Pack a reference-format instance input buffer ([EV|branch|CLV])."""
    lib = load_native()
    S, C = states, categories
    ev = np.ascontiguousarray(np.asarray(ev, np.float32).reshape(-1))
    branch = np.ascontiguousarray(np.asarray(branch, np.float32).reshape(-1))
    clv = np.ascontiguousarray(np.asarray(clv, np.float32).reshape(-1))
    n = clv.size // (S * C)
    header = S * S if combined else 0
    out = np.empty(header + C * S * S + n * C * S, np.float32)
    if lib is None:
        off = 0
        if combined:
            out[:S * S] = ev
            off = S * S
        out[off:off + C * S * S] = branch
        out[off + C * S * S:] = clv
        return out
    written = lib.pack_instance(_f32p(ev), _f32p(branch), _f32p(clv),
                                _f32p(out), n, S, C, 0 if combined else 1)
    assert written == out.size
    return out


def unpack_instance_native(buf, n_sites, states=4, categories=4,
                           combined=True):
    """Inverse of pack_instance_native -> (ev, branch, clv)."""
    lib = load_native()
    S, C = states, categories
    buf = np.ascontiguousarray(np.asarray(buf, np.float32).reshape(-1))
    ev = np.empty(S * S, np.float32)
    branch = np.empty(C * S * S, np.float32)
    clv = np.empty(n_sites * C * S, np.float32)
    if lib is None:
        off = 0
        if combined:
            ev[:] = buf[:S * S]
            off = S * S
        branch[:] = buf[off:off + C * S * S]
        clv[:] = buf[off + C * S * S:off + C * S * S + clv.size]
    else:
        lib.unpack_instance(_f32p(buf), _f32p(ev), _f32p(branch),
                            _f32p(clv), n_sites, S, C,
                            0 if combined else 1)
    return (ev.reshape(S, S), branch.reshape(C, S, S),
            clv.reshape(n_sites, C, S))


def _i32p(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))


def _tree_golden_np(codes, ttab, lsrc, rsrc, oslot, lbr, rbr, ev, rr,
                    states, categories):
    """NumPy fallback for the whole-tree golden oracle.

    Vectorised over sites; the per-site accumulation order (sequential
    over a and k) matches the native/kernel op order exactly, so results
    are bit-identical to the C++ path.
    """
    S, C = states, categories
    n = codes.shape[1]
    n_slots = int(max(oslot.max(), lsrc.max(), rsrc.max())) + 1
    arena = np.zeros((n_slots, n, C, S), np.float32)
    for l in range(codes.shape[0]):
        arena[l] = ttab[:, codes[l]].T[:, None, :]     # (n, 1->C, S)
    minlik = np.float32(np.ldexp(1.0, -32))
    two32 = np.float32(np.ldexp(1.0, 32))
    sc = np.zeros(n, np.int32)
    for e in range(len(lsrc)):
        x1 = arena[lsrc[e]]
        x2 = arena[rsrc[e]]
        u1 = np.zeros((n, C, S), np.float32)
        u2 = np.zeros((n, C, S), np.float32)
        for a in range(S):
            u1 += x1[:, :, a:a + 1] * lbr[e][None, :, :, a]
            u2 += x2[:, :, a:a + 1] * rbr[e][None, :, :, a]
        p = u1 * u2
        out = np.zeros((n, C, S), np.float32)
        for k in range(S):
            out += p[:, :, k:k + 1] * ev[None, None, k, :]
        mask = np.all(np.abs(out) < minlik, axis=(1, 2))
        out[mask] *= two32
        sc += mask.astype(np.int32)
        arena[oslot[e]] = out
    root = arena[oslot[-1]]                            # (n, C, S)
    lik = np.zeros(n, np.float32)
    for a in range(S):
        for c in range(C):
            lik += rr[a * C + c] * root[:, c, a]
    return lik, sc


def plf_tree_golden_native(codes, ttab, lsrc, rsrc, oslot, lbr, rbr, ev,
                           rr, states=4, categories=4,
                           threads: Optional[int] = None):
    """Whole-tree golden oracle: per-site likelihood + rescale counts.

    The tree-level analogue of plf_golden_native — recomputes the entire
    post-order traversal on the host with the device kernels' exact fp32
    op order (the reference verifies every run against a host recompute,
    app/src/host_mem.cpp:403-442).  Arguments use the UNIFIED register
    coordinates of ops/schedule.compile_register_schedule (tips
    in slots [0, n_leaves)); ``lbr``/``rbr`` are (E, C, S, S) branch
    factors in schedule order, ``ttab`` the (S, ncode) tip table,
    ``rr`` the (S*C,) root-row vector.
    """
    S, C = states, categories
    codes = np.ascontiguousarray(np.asarray(codes, np.int32))
    ttab = np.ascontiguousarray(np.asarray(ttab, np.float32))
    lsrc = np.ascontiguousarray(np.asarray(lsrc, np.int32))
    rsrc = np.ascontiguousarray(np.asarray(rsrc, np.int32))
    oslot = np.ascontiguousarray(np.asarray(oslot, np.int32))
    lbr = np.ascontiguousarray(np.asarray(lbr, np.float32))
    rbr = np.ascontiguousarray(np.asarray(rbr, np.float32))
    ev = np.ascontiguousarray(np.asarray(ev, np.float32))
    rr = np.ascontiguousarray(np.asarray(rr, np.float32).reshape(-1))
    lib = load_native()
    if lib is None or not hasattr(lib, "plf_tree_golden_mt"):
        return _tree_golden_np(codes, ttab, lsrc, rsrc, oslot, lbr, rbr,
                               ev, rr, S, C)
    n_leaves, n = codes.shape
    n_slots = int(max(oslot.max(), lsrc.max(), rsrc.max())) + 1
    lik = np.empty(n, np.float32)
    sc = np.empty(n, np.int32)
    if threads is None:
        threads = min(os.cpu_count() or 1, 16)
    lib.plf_tree_golden_mt(
        _i32p(codes), n, n_leaves, _f32p(ttab), ttab.shape[1],
        _i32p(lsrc), _i32p(rsrc), _i32p(oslot), len(lsrc), n_slots,
        _f32p(lbr), _f32p(rbr), _f32p(ev), _f32p(rr), S, C,
        _f32p(lik), _i32p(sc), int(threads))
    return lik, sc


def tree_golden_for_model(pm, threads: Optional[int] = None):
    """Run the whole-tree golden oracle on a PhyloModel's exact inputs.

    Returns (site_lik fp32 (n,), scaler_counts int32 (n,)) — directly
    comparable to the tree paths' outputs before the log (within a few
    ULP: device compilers contract multiply-adds into FMAs).
    """
    from ..io.alignment import map_tip_codes, tip_expansion_table
    from ..models.substitution import branch_matrices
    from ..ops.schedule import compile_register_schedule, reorder_schedule

    cfg = pm.config
    S, C = cfg.states, cfg.categories
    n_leaves = pm.tree.n_leaves
    sched_r = reorder_schedule(pm.schedule, n_leaves)
    arrs, _n_slots, _root = compile_register_schedule(sched_r, n_leaves)
    lsrc, lflag, rsrc, rflag, oslot, eidx = arrs
    lsrc_u = lsrc + lflag * n_leaves
    rsrc_u = rsrc + rflag * n_leaves
    oslot_u = oslot + n_leaves
    lbr, rbr = [], []
    for (_p, _l, _r, tl, tr, _e) in sched_r:
        lbr.append(branch_matrices(pm.model, tl, pm.rates, C))
        rbr.append(branch_matrices(pm.model, tr, pm.rates, C))
    codes = map_tip_codes(pm.tip_states, S)
    ttab = tip_expansion_table(pm.model.w, S).astype(np.float32)
    rr = np.asarray(pm._root_rows, np.float32).reshape(-1)
    return plf_tree_golden_native(
        codes, ttab, lsrc_u, rsrc_u, oslot_u, np.stack(lbr),
        np.stack(rbr), pm.model.plf_ev, rr, states=S, categories=C,
        threads=threads)


def transpose_branch_native(branch, states=4, categories=4):
    """Per-category branch transpose (PL transpose analogue)."""
    lib = load_native()
    S, C = states, categories
    branch = np.ascontiguousarray(
        np.asarray(branch, np.float32).reshape(C, S, S))
    if lib is None:
        return np.ascontiguousarray(np.transpose(branch, (0, 2, 1)))
    out = np.empty_like(branch)
    lib.transpose_branch(_f32p(branch), _f32p(out), S, C)
    return out
