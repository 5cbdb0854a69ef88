"""Kernel-level measurements of the likelihood engine on one NVIDIA GPU.

    python bench.py [--sections probe,node,tree,compile] [--out FILE]

Sections:

* ``probe`` — what the card reaches on a plain 2-read-1-write copy of a
  DNA CLV stream and on a large bf16 matrix product (the ceilings the
  kernels below are read against);
* ``node``  — the single-node PLF (ops/plf_xla.plf_lane_major) at DNA
  16,777,216 sites and S=20 at 2,097,152 sites, against the copy probe
  at the same shape;
* ``tree``  — the whole-tree Triton kernel (ops/tree_triton.py) against
  the XLA traversal (ops/tree_xla.traverse) at 16 and 160 taxa x
  1,048,576 sites, with a block-size sweep for the kernel;
* ``compile`` — the kernel's compile time at 16, 64, 160 and 256 taxa
  (the schedule is data, so it should not grow with the tree).

Every line names the card and its power limit.  Times are the best of
several calls after a warm-up, fenced with ``block_until_ready``;
compile times are cold (``jit(...).lower(...).compile()``).  Results go
to stdout as JSON lines and, with ``--out``, to a file.  Without a GPU
the script exits non-zero before measuring.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import numpy as np

DNA_SITES = 16_777_216
PROTEIN_SITES = 2_097_152
TREE_SITES = 1_048_576


def card() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=30)
    return out.stdout.strip().splitlines()[0]


def best_of(fn, *args, reps: int = 5) -> float:
    import jax
    jax.block_until_ready(fn(*args))
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        best = min(best, time.perf_counter() - t0)
    return best


def compile_timed(fn, *args):
    import jax
    t0 = time.perf_counter()
    compiled = jax.jit(fn).lower(*args).compile()
    return compiled, time.perf_counter() - t0


def section_probe(emit):
    import jax
    import jax.numpy as jnp
    rows = 16
    x1 = jax.random.uniform(jax.random.PRNGKey(0), (rows, DNA_SITES))
    x2 = jax.random.uniform(jax.random.PRNGKey(1), (rows, DNA_SITES))
    t = best_of(jax.jit(lambda a, b: a * 0.5 + b), x1, x2)
    nbytes = 3 * rows * DNA_SITES * 4
    emit(name="copy_probe_2r1w", sites=DNA_SITES, rows=rows, seconds=t,
         gb_per_s=nbytes / t / 1e9)
    del x1, x2
    m = 8192
    a = jax.random.normal(jax.random.PRNGKey(2), (m, m), jnp.bfloat16)
    b = jax.random.normal(jax.random.PRNGKey(3), (m, m), jnp.bfloat16)
    t = best_of(jax.jit(lambda a, b: jnp.dot(
        a, b, preferred_element_type=jnp.float32)), a, b)
    emit(name="matmul_probe_bf16", m=m, seconds=t,
         tflops=2 * m ** 3 / t / 1e12)


def section_node(emit):
    import jax
    import jax.numpy as jnp
    from plf_tpu.ops.plf_xla import plf_lane_major
    for S, n, variants in ((4, DNA_SITES, ("vpu",)),
                           (20, PROTEIN_SITES, ("mxu", "mxu_3x", "vpu"))):
        C = 4
        rows = S * C
        x1 = jax.random.uniform(jax.random.PRNGKey(0), (rows, n))
        x2 = jax.random.uniform(jax.random.PRNGKey(1), (rows, n))
        b = jax.random.uniform(jax.random.PRNGKey(2), (C, S, S))
        ev = jax.random.uniform(jax.random.PRNGKey(3), (S, S))
        nbytes = 3 * rows * n * 4
        t_copy = best_of(jax.jit(lambda a, c: a * 0.5 + c), x1, x2)
        emit(name="copy_probe_2r1w", states=S, sites=n, seconds=t_copy,
             gb_per_s=nbytes / t_copy / 1e9)
        for v in variants:
            f = jax.jit(lambda a, c, b, e, v=v: plf_lane_major(
                a, c, b, b, e, n, states=S, categories=C, variant=v))
            t = best_of(f, x1, x2, b, ev)
            emit(name="plf_node_xla", states=S, sites=n, variant=v,
                 seconds=t, gsites_per_s=n / t / 1e9,
                 gb_per_s=nbytes / t / 1e9, share_of_probe=t_copy / t)
        del x1, x2


def tree_case(taxa: int, sites: int, seed: int = 0):
    """A DNA GTR+G4 case on a random tree with uniform random codes."""
    import jax.numpy as jnp
    from plf_tpu import PLFConfig
    from plf_tpu.models import PhyloModel, gtr, random_tree
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 4, size=(taxa, sites), dtype=np.int8)
    model = gtr(rng.uniform(0.5, 4.0, 6), rng.dirichlet(np.full(4, 8.0)))
    pm = PhyloModel(random_tree(taxa, seed=seed), model, codes, alpha=0.5,
                    config=PLFConfig(tip_dtype="int8"))
    lops, rops = pm._ops
    return pm, lops, rops, jnp.stack([lops, rops], axis=1)


def section_tree(emit):
    from plf_tpu.ops import tree_triton
    from plf_tpu.ops.tree_xla import traverse
    n = TREE_SITES
    for taxa in (16, 160):
        pm, lops, rops, ops = tree_case(taxa, n)
        args = (pm._ev, pm._tip_table, pm._root_rows)
        sched3 = tuple((p, l, r) for (p, l, r, *_x) in pm._sched_r)
        xla, t_cx = compile_timed(
            lambda c, lo, ro: traverse(c, lo, ro, *args, n, schedule=sched3,
                                       n_leaves=taxa)[:2],
            pm._codes, lops, rops)
        t_x = best_of(xla, pm._codes, lops, rops)
        lik_x, sc_x = xla(pm._codes, lops, rops)
        emit(name="tree_xla_traversal", taxa=taxa, sites=n, seconds=t_x,
             gsites_per_s=n / t_x / 1e9, compile_s=t_cx,
             memory=str(xla.memory_analysis()))
        default = tree_triton.choose_block(pm.n_pad)
        for block in (128, 256, 512):
            kern, t_ck = compile_timed(
                lambda c, o, block=block: tree_triton.plf_tree_triton(
                    c, pm._sched_r, o, *args, n, block_sites=block),
                pm._codes, ops)
            t_k = best_of(kern, pm._codes, ops)
            lik, sc = kern(pm._codes, ops)
            rel = float(np.max(np.abs(np.asarray(lik, np.float64)
                                      / np.asarray(lik_x, np.float64) - 1)))
            emit(name="tree_triton_kernel", taxa=taxa, sites=n, block=block, default_block=block == default, seconds=t_k,
                 gsites_per_s=n / t_k / 1e9, compile_s=t_ck,
                 speedup_vs_xla=t_x / t_k, max_rel_lik_vs_xla=rel,
                 scalers_equal=bool(np.array_equal(np.asarray(sc),
                                                   np.asarray(sc_x))))


def section_compile(emit):
    from plf_tpu.ops import tree_triton
    for taxa in (16, 64, 160, 256):
        pm, lops, rops, ops = tree_case(taxa, TREE_SITES, seed=taxa)
        args = (pm._ev, pm._tip_table, pm._root_rows)
        kern, t_c = compile_timed(
            lambda c, o: tree_triton.plf_tree_triton(
                c, pm._sched_r, o, *args, pm.n_sites), pm._codes, ops)
        t = best_of(kern, pm._codes, ops)
        emit(name="tree_triton_compile", taxa=taxa, nodes=taxa - 1,
             compile_s=t_c, run_seconds=t)


SECTIONS = {"probe": section_probe, "node": section_node,
            "tree": section_tree, "compile": section_compile}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--sections", default="probe,node,tree,compile")
    ap.add_argument("--out", default=None, help="also write JSON lines here")
    args = ap.parse_args(argv)
    import jax
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"bench.py measures a GPU; found {dev.platform!r}",
              file=sys.stderr)
        return 2
    from plf_tpu.utils.compile_cache import enable_compile_cache
    enable_compile_cache()
    where = {"card": card(), "platform": dev.platform,
             "kind": dev.device_kind, "count": len(jax.devices())}
    out = open(args.out, "a") if args.out else None

    def emit(**row):
        line = json.dumps({**row, **where})
        print(line, flush=True)
        if out:
            out.write(line + "\n")
            out.flush()

    try:
        for name in args.sections.split(","):
            SECTIONS[name](emit)
    finally:
        if out:
            out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
