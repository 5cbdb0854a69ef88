"""Smoke run of the likelihood engine's main path on one NVIDIA GPU.

    python chip_smoke.py [--seed N]          # every phase, one card
    python chip_smoke.py --four [--seed N]   # site sharding on four cards

One process drives the card through the library's own entry points at
the repository's real sizes, compiled (no kernel runs in interpret mode),
and checks every result against a reference:

1. single-node PLF (``PLFEngine.plf``): DNA at 16,777,216 sites, and
   S=20 at 2,097,152 sites at kernel variants mxu and mxu_3x, against
   the threaded native golden model;
2. whole-tree likelihood (``PhyloModel.log_likelihood``): DNA GTR+G4,
   160 taxa x 1,048,576 sites, int8 tip codes, against the XLA
   traversal on the card and, on a 16,384-site slice, the native golden
   tree;
3. training: ``value_and_grad`` of ``tree_loglik_fn`` on that model, three
   ``optimize_branch_lengths`` steps, and the gradient of a 16 x 65,536
   model against the same function on the CPU;
4. protein forward: S=20, 64 taxa x 131,072 sites at mxu_3x and mxu;
5. one NNI round (``tree_search``) at 256 taxa x 16,384 sites and
   ``run_inference`` on a simulated 32 x 100,000 alignment.

``--four`` runs only the sharded forward and ``value_and_grad`` at 160
taxa x 4,194,304 sites on a four-device ``sites`` mesh, against one
device.  A failed check raises; the last line of a passing run is one
JSON object naming the device.  Without a GPU the script exits non-zero
before any phase.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np


def log(*a):
    print(*a, flush=True)


def card_line() -> str:
    """``name, power.limit`` of each card, as nvidia-smi reports them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi unavailable: {e}"
    return out.stdout.strip() or out.stderr.strip()


def _timed(fn, reps: int = 3):
    """(result, first-call seconds, best steady-state seconds)."""
    import jax
    t0 = time.perf_counter()
    out = jax.block_until_ready(fn())
    first = time.perf_counter() - t0
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        out = jax.block_until_ready(fn())
        best = min(best, time.perf_counter() - t0)
    return out, first, best


def _check(name: str, got, ref, rtol: float, atol: float) -> float:
    """Raise unless |got - ref| <= atol + rtol |ref| everywhere; returns
    the largest relative deviation."""
    got = np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    if got.shape != ref.shape:
        raise AssertionError(f"{name}: shape {got.shape} != {ref.shape}")
    if not np.all(np.isfinite(got)):
        raise AssertionError(f"{name}: non-finite values")
    err = np.abs(got - ref)
    bad = err > atol + rtol * np.abs(ref)
    if bad.any():
        i = int(np.argmax(bad.reshape(-1)))
        raise AssertionError(
            f"{name}: {int(bad.sum())} elements beyond rtol={rtol} "
            f"atol={atol}; first at flat index {i}: "
            f"{got.reshape(-1)[i]!r} vs {ref.reshape(-1)[i]!r}")
    return float(np.max(err / np.maximum(np.abs(ref), 1e-300)))


def _equal(name: str, got, ref):
    if not np.array_equal(np.asarray(got), np.asarray(ref)):
        raise AssertionError(f"{name}: differs")


def _peak_gb(device=None) -> float:
    import jax
    stats = (device or jax.devices()[0]).memory_stats() or {}
    return stats.get("peak_bytes_in_use", 0) / 1e9


def _random_tips(rng, taxa: int, sites: int, states: int = 4):
    return rng.integers(0, states, size=(taxa, sites), dtype=np.int8)


def _dna_model(seed: int):
    from plf_tpu.models import gtr
    rng = np.random.default_rng(seed)
    pi = rng.dirichlet(np.full(4, 8.0))
    return gtr(rng.uniform(0.5, 4.0, 6), pi)


# ---------------------------------------------------------------- phases ---

def phase_single_node(seed: int, n_dna: int = 16_777_216,
                      n_prot: int = 2_097_152) -> None:
    """``PLFEngine.plf`` against the threaded native golden model."""
    import jax.numpy as jnp

    from plf_tpu import PLFConfig, PLFEngine
    from plf_tpu.__main__ import make_data
    from plf_tpu.ops.plf_xla import DOT_ALGORITHM
    from plf_tpu.runtime.native import plf_golden_native

    # (states, sites, variant, rtol): DNA holds the golden model's own
    # bound (FMA contraction only); the dots sum S=20 positive products
    # in another order (mxu) or from bf16x3-split operands (mxu_3x).
    cases = [(4, n_dna, "vpu", 5e-7), (20, n_prot, "mxu", 1e-5),
             (20, n_prot, "mxu_3x", 1e-4)]
    for S, n, variant, rtol in cases:
        case = make_data(n, S, 4, seed=seed)
        dev = [jnp.asarray(a) for a in case]
        eng = PLFEngine(PLFConfig(states=S, kernel_variant=variant))
        out, first, steady = _timed(lambda: eng.plf(*dev).x3)
        res = eng.plf(*dev)
        ref = plf_golden_native(*case, states=S, categories=4)
        dev_rel = _check(f"single-node S={S} {variant} x3",
                         np.asarray(res.x3), ref[0], rtol, 1e-37)
        _equal(f"single-node S={S} {variant} scalers",
               np.asarray(res.scaler_vector), ref[1].astype(np.int32))
        if int(res.scaler_increment) != int(ref[2]):
            raise AssertionError("scaler increment differs")
        alg = DOT_ALGORITHM.get(variant, "none (element-wise)")
        log(f"[single-node] S={S} sites={n} path=xla variant={variant} "
            f"dot={getattr(alg, 'name', alg)} first-call={first:.3f}s "
            f"steady={steady * 1e3:.3f}ms "
            f"({n / steady / 1e9:.3f} Gsites/s) vs golden: max rel "
            f"{dev_rel:.2e} <= rtol {rtol}, scalers equal "
            f"({int(ref[2])} rescaled)")
        del case, dev, out, res, ref


def phase_tree(seed: int, taxa: int = 160, sites: int = 1_048_576,
               golden_sites: int = 16_384, interpret: bool = False) -> None:
    """``PhyloModel.log_likelihood`` (auto -> whole-tree kernel) against
    the XLA traversal and, on a slice, the native golden tree."""
    from plf_tpu import PLFConfig
    from plf_tpu.models import PhyloModel, random_tree
    from plf_tpu.ops import tree_triton
    from plf_tpu.runtime.native import tree_golden_for_model

    rng = np.random.default_rng(seed)
    tips = _random_tips(rng, taxa, sites)
    tree = random_tree(taxa, seed=seed)
    model = _dna_model(seed)
    cfg = PLFConfig(tip_dtype="int8", interpret=interpret)
    pm = PhyloModel(tree, model, tips, alpha=0.5, config=cfg)
    method = "fused" if interpret else "auto"
    res, first, steady = _timed(lambda: pm.log_likelihood(method=method))
    if res.method != "fused":
        raise AssertionError(f"auto took {res.method!r}, not the kernel")
    block = tree_triton.choose_block(pm.n_pad)
    log(f"[tree] {taxa} taxa x {sites} sites (uniform random int8 codes) "
        f"path=triton kernel block={block} first-call={first:.3f}s "
        f"steady={steady * 1e3:.3f}ms ({sites / steady / 1e9:.3f} "
        f"Gsites/s) ll={res.log_likelihood:.6f}")
    ref, first_x, steady_x = _timed(
        lambda: pm.log_likelihood(method="per-node"))
    rel = _check("tree site ll vs XLA traversal", res.site_log_likelihood,
                 ref.site_log_likelihood, 5e-6, 1e-7)
    _equal("tree scalers vs XLA traversal", res.scaler_sites,
           ref.scaler_sites)
    log(f"[tree] XLA traversal first-call={first_x:.3f}s "
        f"steady={steady_x * 1e3:.3f}ms; site ll max rel {rel:.2e} "
        f"(rtol 5e-6, atol 1e-7), scalers equal "
        f"({res.scaler_total} rescales)")
    small = PhyloModel(tree, model, tips[:, :golden_sites], alpha=0.5,
                       config=cfg)
    got = small.log_likelihood(method=method)
    glik, gsc = tree_golden_for_model(small)
    rel = _check("tree slice vs golden", got.site_log_likelihood,
                 np.log(glik.astype(np.float64)), 5e-6, 1e-7)
    _equal("tree slice scalers vs golden", got.scaler_sites, gsc)
    log(f"[tree] {golden_sites}-site slice vs native golden tree: site ll "
        f"max rel {rel:.2e} (rtol 5e-6, atol 1e-7), scalers equal; "
        f"peak device memory {_peak_gb():.2f} GB")


def phase_training(seed: int, taxa: int = 160, sites: int = 1_048_576,
                   cmp_taxa: int = 16, cmp_sites: int = 65_536,
                   steps: int = 3) -> None:
    """value_and_grad of tree_loglik_fn, three optimiser steps, and the
    gradient against the same function on the CPU."""
    import jax
    import jax.numpy as jnp

    from plf_tpu import PLFConfig
    from plf_tpu.models import PhyloModel, random_tree
    from plf_tpu.models.optimize import (optimize_branch_lengths,
                                         tree_loglik_fn)

    rng = np.random.default_rng(seed + 1)
    model = _dna_model(seed)
    cfg = PLFConfig(tip_dtype="int8")
    pm = PhyloModel(random_tree(taxa, seed=seed), model,
                    _random_tips(rng, taxa, sites), alpha=0.5, config=cfg)
    fn, t0 = tree_loglik_fn(pm)
    if fn.engine != "xla":
        raise AssertionError(f"training engine {fn.engine!r}")
    # the alignment rides as arguments, not as constants of the program
    step = jax.jit(jax.value_and_grad(fn))
    t = jnp.asarray(t0)
    tc = time.perf_counter()
    compiled = step.lower(t, *fn.data).compile()
    compile_s = time.perf_counter() - tc
    log(f"[training] memory_analysis of the value_and_grad step "
        f"({taxa} x {sites}): {compiled.memory_analysis()}")
    (val, g), first, steady = _timed(lambda: compiled(t, *fn.data))
    if not (np.isfinite(float(val)) and np.all(np.isfinite(np.asarray(g)))):
        raise AssertionError("non-finite likelihood or gradient")
    log(f"[training] {taxa} x {sites} value_and_grad path=xla autodiff "
        f"variant={fn.variant} compile={compile_s:.1f}s "
        f"steady={steady * 1e3:.3f}ms ll={float(val):.6f} "
        f"|g|max={float(jnp.abs(g).max()):.4e}; peak device memory "
        f"{_peak_gb():.2f} GB")
    tc = time.perf_counter()
    _, ll0, ll1 = optimize_branch_lengths(pm, steps=steps)
    if not ll1 > ll0:
        raise AssertionError(f"optimiser did not raise ll: {ll0} -> {ll1}")
    log(f"[training] optimize_branch_lengths {steps} steps: "
        f"ll {ll0:.6f} -> {ll1:.6f} ({time.perf_counter() - tc:.1f}s "
        f"incl. compile)")
    del pm, fn, step, compiled, g

    tips = _random_tips(rng, cmp_taxa, cmp_sites)
    tree = random_tree(cmp_taxa, seed=seed + 2)

    def grad_on(device):
        with jax.default_device(device):
            pm_d = PhyloModel(tree, model, tips, alpha=0.5, config=cfg)
            f, t0_d = tree_loglik_fn(pm_d)
            v, g_d = jax.value_and_grad(f)(jnp.asarray(t0_d))
            return float(v), np.asarray(g_d)

    v_dev, g_dev = grad_on(jax.devices()[0])
    v_cpu, g_cpu = grad_on(jax.devices("cpu")[0])
    rel = _check("gradient vs CPU", g_dev, g_cpu, 5e-4, 1e-4)
    _check("ll vs CPU", v_dev, v_cpu, 1e-5, 0.0)
    log(f"[training] {cmp_taxa} x {cmp_sites} gradient vs the CPU: max "
        f"rel {rel:.2e} (rtol 5e-4, atol 1e-4); ll {v_dev:.6f} vs "
        f"{v_cpu:.6f}")


def phase_protein(seed: int, taxa: int = 64, sites: int = 131_072,
                  check_sites: int = 4_096) -> None:
    """S=20 forward at mxu_3x and mxu, each checked on a slice against
    the float64 brute-force pruning (the total: eigen-coordinate CLVs
    are mixed-sign at S=20, so single sites differ between fp32 summation
    orders by cancellation, while the sum holds fp32 grade)."""
    from plf_tpu import PLFConfig
    from plf_tpu.models import PhyloModel, empirical_protein, random_tree
    from plf_tpu.ops.plf_xla import DOT_ALGORITHM

    rng = np.random.default_rng(seed + 3)
    tips = _random_tips(rng, taxa, sites, states=20)
    tree = random_tree(taxa, seed=seed + 3, mean_branch=0.1)
    lg = empirical_protein("lg")
    lls = {}
    for variant, rtol in (("mxu_3x", 1e-4), ("mxu", 1e-6)):
        cfg = PLFConfig(states=20, kernel_variant=variant, tip_dtype="int8")
        pm = PhyloModel(tree, lg, tips, alpha=0.8, config=cfg)
        res, first, steady = _timed(lambda: pm.log_likelihood())
        if not np.isfinite(res.log_likelihood):
            raise AssertionError(f"protein {variant}: non-finite ll")
        lls[variant] = res.log_likelihood
        small = PhyloModel(tree, lg, tips[:, :check_sites], alpha=0.8,
                           config=cfg)
        rel = _check(f"protein {variant} slice vs brute force",
                     small.log_likelihood().log_likelihood,
                     small.log_likelihood_bruteforce(), rtol, 0.0)
        log(f"[protein] S=20 {taxa} x {sites} (uniform random codes) "
            f"path={res.method} (xla) variant={variant} "
            f"dot={DOT_ALGORITHM[variant].name} first-call={first:.3f}s "
            f"steady={steady * 1e3:.3f}ms ll={res.log_likelihood:.6f}; "
            f"{check_sites}-site slice vs float64 brute force: rel "
            f"{rel:.2e} (rtol {rtol})")
    diff = lls["mxu_3x"] - lls["mxu"]
    log(f"[protein] ll(mxu_3x) - ll(mxu) = {diff:.6f} "
        f"({diff / abs(lls['mxu']):.3e} relative)")


def phase_search(seed: int, taxa: int = 256, sites: int = 16_384,
                 pipe_taxa: int = 32, pipe_sites: int = 100_000) -> None:
    """One NNI round through tree_search, then run_inference."""
    from plf_tpu.models import (random_tree, run_inference,
                                simulate_alignment, tree_search)
    from plf_tpu.models.search import nni_neighbors

    model = _dna_model(seed)
    true_tree = random_tree(taxa, seed=seed + 4, mean_branch=0.05)
    t0 = time.perf_counter()
    tips = simulate_alignment(true_tree, model, sites, alpha=0.5,
                              seed=seed + 4)
    sim_s = time.perf_counter() - t0
    start = random_tree(taxa, seed=seed + 5, mean_branch=0.05)
    n_cand = len(nni_neighbors(start))
    t0 = time.perf_counter()
    res = tree_search(start, model, tips, alpha=0.5, strategy="nni",
                      max_rounds=1)
    search_s = time.perf_counter() - t0
    if not np.isfinite(res.log_likelihood) or res.evaluations < n_cand:
        raise AssertionError(f"search: {res}")
    log(f"[search] NNI round {taxa} taxa x {sites} sites (simulated in "
        f"{sim_s:.1f}s): {n_cand} candidates in one batched XLA program "
        f"(schedule as data), {search_s:.1f}s incl. compile, "
        f"accepted={res.accepted_moves} ll={res.log_likelihood:.4f}")
    tree = random_tree(pipe_taxa, seed=seed + 6, mean_branch=0.1)
    codes = simulate_alignment(tree, model, pipe_sites, alpha=0.5,
                               seed=seed + 6)
    t0 = time.perf_counter()
    out = run_inference(codes, model=model, alpha=0.5, search="nni",
                        fit="lengths", progress=lambda m: log(f"  {m}"))
    if not np.isfinite(out.log_likelihood):
        raise AssertionError("run_inference: non-finite ll")
    log(f"[pipeline] run_inference {pipe_taxa} x {pipe_sites} (simulated): "
        f"ll={out.log_likelihood:.4f} in {time.perf_counter() - t0:.1f}s")


def phase_four(seed: int, taxa: int = 160, sites: int = 4_194_304,
               n_devices: int = 4, interpret: bool = False) -> None:
    """Sharded forward and value_and_grad on a ``sites`` mesh against
    one device (the gradient as the sum over per-device slices)."""
    import jax
    import jax.numpy as jnp

    from plf_tpu import PLFConfig
    from plf_tpu.models import PhyloModel, random_tree
    from plf_tpu.models.optimize import tree_loglik_fn
    from plf_tpu.parallel import make_mesh

    devices = jax.devices()[:n_devices]
    if len(devices) != n_devices:
        raise AssertionError(f"need {n_devices} devices: {jax.devices()}")
    mesh = make_mesh(n_devices)
    # the tree, model and slice size of phase_training: the one-device
    # slice gradient compiles to the program that phase compiled
    rng = np.random.default_rng(seed + 7)
    tips = _random_tips(rng, taxa, sites)
    tree = random_tree(taxa, seed=seed)
    model = _dna_model(seed)
    cfg = PLFConfig(tip_dtype="int8", interpret=interpret)
    method = "fused" if interpret else "auto"
    pm = PhyloModel(tree, model, tips, alpha=0.5, config=cfg)
    # The one-device reference gradient: equal slices share site count
    # and weights, so one compiled program serves every slice with its
    # alignment as data.  It compiles in a thread beside the sharded
    # program (compiles release the GIL).
    part = sites // n_devices
    slices = [tips[:, k * part:(k + 1) * part] for k in range(n_devices)]
    f_0, t0 = tree_loglik_fn(PhyloModel(tree, model, slices[0], alpha=0.5,
                                        config=cfg))
    t = jnp.asarray(t0)
    slice_step = jax.jit(jax.value_and_grad(f_0))
    tc = time.perf_counter()
    with ThreadPoolExecutor(1) as pool:
        slice_compile = pool.submit(
            lambda: slice_step.lower(t, *f_0.data).compile())
        sh, first, steady = _timed(
            lambda: pm.log_likelihood_sharded(mesh, method=method))
        log(f"[four] sharded forward {taxa} x {sites} on {n_devices} "
            f"devices path={sh.method} first-call={first:.3f}s "
            f"steady={steady * 1e3:.3f}ms ll={sh.log_likelihood:.6f}")
        fn, _ = tree_loglik_fn(pm, mesh=mesh)
        step = jax.jit(jax.value_and_grad(fn))
        (v_sh, g_sh), first, steady = _timed(lambda: step(t, *fn.data))
        g_sh = np.asarray(g_sh)
        log(f"[four] sharded value_and_grad path=xla autodiff under "
            f"shard_map first-call={first:.1f}s steady={steady * 1e3:.3f}ms "
            f"ll={float(v_sh):.6f}")
        peaks = [_peak_gb(d) for d in devices]
        log(f"[four] peak device memory per device (GB): "
            f"{[round(p, 3) for p in peaks]}")
        if min(peaks) < 0.25 * max(peaks):
            raise AssertionError(
                f"work did not spread over the mesh: {peaks}")
        del fn, step
        compiled = slice_compile.result()
    ready_s = time.perf_counter() - tc

    one, first, steady = _timed(lambda: pm.log_likelihood(method=method))
    rel = _check("sharded vs one-device site ll", sh.site_log_likelihood,
                 one.site_log_likelihood, 5e-6, 1e-7)
    _equal("sharded vs one-device scalers", sh.scaler_sites,
           one.scaler_sites)
    _check("sharded vs one-device ll", sh.log_likelihood,
           one.log_likelihood, 1e-6, 0.0)
    log(f"[four] one-device forward path={one.method} "
        f"steady={steady * 1e3:.3f}ms: site ll max rel {rel:.2e} (rtol "
        f"5e-6, atol 1e-7), scalers equal, ll {one.log_likelihood:.6f}")
    del pm, one
    v_sum, g_sum = 0.0, np.zeros_like(g_sh)
    for k, codes in enumerate(slices):
        f_k = f_0 if k == 0 else tree_loglik_fn(PhyloModel(
            tree, model, codes, alpha=0.5, config=cfg))[0]
        v_k, g_k = compiled(t, *f_k.data)
        v_sum += float(v_k)
        g_sum += np.asarray(g_k)
        del f_k
    rel = _check("sharded gradient vs sum of slices", g_sh, g_sum, 5e-4,
                 1e-4)
    _check("sharded ll vs sum of slices", float(v_sh), v_sum, 1e-5, 0.0)
    log(f"[four] one-device gradient as the sum over {n_devices} slices "
        f"of {part} sites (one program, compiled beside the sharded one, "
        f"ready after {ready_s:.1f}s): "
        f"max rel {rel:.2e} (rtol 5e-4, atol 1e-4); ll {v_sum:.6f}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--four", action="store_true",
                    help="run only the four-device site-sharding phases")
    args = ap.parse_args(argv)

    import jax
    devices = jax.devices()
    log(f"jax.devices(): {devices}")
    for d in devices:
        log(f"  device {d.id}: platform={d.platform} kind={d.device_kind}")
    log(f"card: {card_line()}")
    if devices[0].platform != "gpu":
        print(f"no GPU: jax.devices()[0].platform is "
              f"{devices[0].platform!r}", file=sys.stderr)
        return 2

    from plf_tpu.utils.compile_cache import enable_compile_cache
    log(f"compile cache: {enable_compile_cache()}")
    t_all = time.perf_counter()
    if args.four:
        phases = [lambda: phase_four(args.seed)]
    else:
        phases = [lambda: phase_single_node(args.seed),
                  lambda: phase_tree(args.seed),
                  lambda: phase_training(args.seed),
                  lambda: phase_protein(args.seed),
                  lambda: phase_search(args.seed)]
    for run in phases:
        t0 = time.perf_counter()
        run()
        log(f"  phase took {time.perf_counter() - t0:.1f}s")
    log(f"all phases passed in {time.perf_counter() - t_all:.1f}s")
    log(f"card: {card_line()}")
    d = jax.devices()[0]
    print(json.dumps({"ok": True, "device": {
        "platform": d.platform, "kind": d.device_kind,
        "count": len(jax.devices())}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
