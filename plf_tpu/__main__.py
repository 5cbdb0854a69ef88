"""plf_tpu CLI — the host_mem.exe equivalent.

The reference's primary entry point is
``host_mem.exe <xclbin> <BDF> <alignment_sites> <plf_calls> <instances>``
(app/src/host_mem.cpp:13-14): print the config/geometry report, generate
random inputs with a forced-underflow pattern, run the benchmark loop,
verify against the CPU golden model, and print timing/bandwidth tables.

Equivalent here::

    python -m plf_tpu [config-name] --sites N --calls K --instances I
                      [--no-verify] [--csv out.csv]

The positional config-name plays the xclbin-filename role and is parsed
with the same semantics (config.PLFConfig.from_name).

Beyond the reference's benchmark driver, ``infer`` runs the full ML
pipeline on a real alignment (models/pipeline.py)::

    python -m plf_tpu infer align.fasta [--model jc|hky|gtr]
        [--alpha A] [--pinv P] [--search nni|spr|none]
        [--bootstrap N] [--out tree.nwk]
"""

from __future__ import annotations

import argparse
import sys

import numpy as np


def log(*a):
    print(*a, flush=True)


def make_data(n, states, categories, seed=7):
    """Random inputs incl. the reference's forced-underflow pattern
    (host_mem.cpp:179-209: scale=1e-12 for element index j%64<16)."""
    rng = np.random.default_rng(seed)
    S, C = states, categories
    e = S * C
    x1 = rng.random((n * e,), dtype=np.float32)
    j = np.arange(n * e)
    x1 = np.where(j % (4 * e) < e, x1 * np.float32(1e-12), x1)
    x2 = rng.random((n * e,), dtype=np.float32)
    ev = rng.random((S, S), dtype=np.float32)
    left = rng.random((C, S, S), dtype=np.float32)
    right = rng.random((C, S, S), dtype=np.float32)
    wgt = np.ones((n,), dtype=np.int32)
    return (x1.reshape(n, C, S), x2.reshape(n, C, S), left, right, ev, wgt)


def infer_main(argv):
    ap = argparse.ArgumentParser(prog="python -m plf_tpu infer")
    ap.add_argument("alignment",
                    help="FASTA or PHYLIP file (DNA, or protein for "
                         "--model lg/wag)")
    ap.add_argument("--model", default="jc",
                    choices=["auto", "jc", "hky", "gtr", "lg", "wag",
                             "jtt", "dayhoff", "mtrev", "cprev",
                             "gy94"],
                    help="'auto' runs AICc model selection first "
                         "(models/selection): the JC/HKY/GTR +G/+I "
                         "ladder for DNA, the LG/WAG/JTT/Dayhoff "
                         "x{+G,+I,+I+G}x{+F} ladder for protein, "
                         "GY94/GY94+G for codon data; 'gy94' fits "
                         "omega/kappa by ML (fit_codon) directly")
    ap.add_argument("--seq-type", default="auto",
                    choices=["auto", "dna", "protein", "codon"],
                    help="alignment alphabet; 'auto' treats the data as "
                         "protein when >10%% of residues fall outside "
                         "the DNA alphabet incl. IUPAC ambiguity codes")
    ap.add_argument("--kappa", type=float, default=2.0,
                    help="HKY transition/transversion ratio")
    ap.add_argument("--alpha", type=float, default=None,
                    help="initial gamma shape (enables +G)")
    ap.add_argument("--pinv", type=float, default=None,
                    help="initial invariant proportion (enables +I)")
    ap.add_argument("--search", default="nni",
                    choices=["nni", "spr", "mixed", "none"])
    ap.add_argument("--fit", default="lengths+alpha",
                    help="'+'-joined: lengths, alpha, pinv, model, none")
    ap.add_argument("--bootstrap", type=int, default=0)
    ap.add_argument("--out", default=None, help="write newick here")
    args = ap.parse_args(argv)

    from .models import empirical_protein, hky85, jc69, run_inference

    with open(args.alignment) as f:
        text = f.read()
    from .models.substitution import BUILTIN_PROTEIN_MODELS
    codon = args.seq_type == "codon" or args.model == "gy94"
    if args.seq_type == "auto" and not codon:
        protein = (args.model in BUILTIN_PROTEIN_MODELS
                   or _detect_protein(text))
    else:
        protein = args.seq_type == "protein"
    aln = _parse_alignment(text, protein=protein)
    if codon:
        # codon data arrives as in-frame DNA; encode to 61 states
        from .io.alignment import Alignment
        from .models.substitution import encode_codon_alignment
        aln = Alignment(aln.names, encode_codon_alignment(aln.codes))
        return _infer_codon(args, aln)
    if args.model in BUILTIN_PROTEIN_MODELS:
        model = empirical_protein(args.model)
    elif args.model == "auto":
        # ModelTest step: rank the candidate ladder by AICc on an NJ
        # starting tree, then run the full inference under the winner
        # (DNA: JC/HKY/GTR +G/+I; protein: the empirical-table ladder).
        from .config import PLFConfig
        from .models import model_select, nj_tree
        comp = aln.compressed()
        # the NJ distances must use the alignment's alphabet size:
        # with the default states=4, protein codes 4-19 would count as
        # gap/ambiguous and the start tree degenerates
        start = nj_tree(comp.codes, comp.weights,
                        states=20 if protein else 4)
        cfg_sel = PLFConfig(states=20) if protein else None
        sel = model_select(start, comp.codes, wgt=comp.weights,
                           config=cfg_sel)
        log("model selection (AICc):\n" + sel.table())
        log(f"selected: {sel.best.name}")
        model = sel.best.model
        if sel.best.alpha is not None and args.alpha is None:
            args.alpha = sel.best.alpha
        if sel.best.p_inv is not None and args.pinv is None:
            args.pinv = sel.best.p_inv
        args.model = sel.best.name.partition("+")[0].lower()
    else:
        model = {"jc": jc69, "hky": lambda: hky85(args.kappa),
                 "gtr": jc69}[args.model]()
    fit = args.fit if args.model != "gtr" else args.fit + "+model"
    res = run_inference(aln.codes, names=aln.names, model=model,
                        alpha=args.alpha, p_inv=args.pinv,
                        search=args.search, fit=fit,
                        bootstrap=args.bootstrap, progress=log)
    log(f"final ll = {res.log_likelihood:.6f}  "
        f"(alpha={res.alpha}, p_inv={res.p_inv}, {res.elapsed_s:.1f}s)")
    log(res.newick)
    if args.out:
        with open(args.out, "w") as f:
            f.write(res.newick + "\n")
        log(f"wrote {args.out}")
    return 0


def _infer_codon(args, aln) -> int:
    """Codon-model inference: GY94 omega/kappa ML fit (or GY94 vs
    GY94+G selection with --model auto), then the standard pipeline
    under the fitted model."""
    from .config import PLFConfig
    from .models import model_select, nj_tree, run_inference
    from .models.optimize import fit_codon

    comp = aln.compressed()
    cfg = PLFConfig(states=61, kernel_variant="auto", block_sites=1024)
    start = nj_tree(comp.codes, comp.weights, states=61)
    if args.model == "auto":
        sel = model_select(start, comp.codes, wgt=comp.weights,
                           config=cfg)
        log("codon model selection (AICc):\n" + sel.table())
        log(f"selected: {sel.best.name}")
        model = sel.best.model
        alpha = sel.best.alpha
    else:
        model, info = fit_codon(start, comp.codes, wgt=comp.weights,
                                config=cfg, fit_alpha=args.alpha
                                is not None, verbose=True)
        log(f"GY94 fit: kappa={info['kappa']:.3f} "
            f"omega={info['omega']:.4f} ll={info['ll']:.4f}")
        alpha = info["alpha"]
    res = run_inference(aln.codes, names=aln.names, model=model,
                        alpha=alpha, search=args.search,
                        fit="lengths", bootstrap=args.bootstrap,
                        progress=log)
    log(f"final ll = {res.log_likelihood:.6f}  ({res.elapsed_s:.1f}s)")
    log(res.newick)
    if args.out:
        with open(args.out, "w") as f:
            f.write(res.newick + "\n")
        log(f"wrote {args.out}")
    return 0


def _detect_protein(text: str) -> bool:
    """Protein if a meaningful FRACTION of residues falls outside the
    DNA alphabet (>10%) — a stray X/ambiguity code in a DNA file
    must not silently flip the whole alignment to the 20-state
    encoding (the RAxML-style heuristic: DNA alignments are >~90%
    ACGTUN/IUPAC/gap).  The DNA set includes the IUPAC nucleotide
    ambiguity codes (R/Y/S/W/K/M/B/D/H/V and X): an ambiguity-rich
    DNA alignment is still DNA."""
    from .io.alignment import parse_fasta, parse_phylip
    if text.lstrip().startswith(">"):
        _, seqs = parse_fasta(text)
    else:
        _, seqs = parse_phylip(text)
    dna = set("ACGTUN-?.RYSWKMBDHVX")
    dna |= set(c.lower() for c in dna)
    total = nondna = 0
    for seq in seqs:
        for ch in seq:
            total += 1
            if ch not in dna:
                nondna += 1
    return total > 0 and nondna / total > 0.10


def _parse_alignment(text: str, protein: bool = False):
    from .io.alignment import (Alignment, parse_fasta, parse_phylip,
                               encode_dna, encode_protein)
    if text.lstrip().startswith(">"):
        names, seqs = parse_fasta(text)
    else:
        names, seqs = parse_phylip(text)
    enc = encode_protein if protein else encode_dna
    return Alignment(names, enc(seqs))


def main(argv=None):
    if argv is None:
        argv = sys.argv[1:]
    from .utils.compile_cache import enable_compile_cache
    enable_compile_cache()
    if argv and argv[0] == "infer":
        return infer_main(argv[1:])
    ap = argparse.ArgumentParser(prog="python -m plf_tpu")
    ap.add_argument("config", nargs="?", default=None,
                    help="config name (xclbin-filename analogue)")
    ap.add_argument("--sites", type=int, default=100_000)
    ap.add_argument("--calls", type=int, default=10)
    ap.add_argument("--instances", type=int, default=1)
    ap.add_argument("--block", type=int, default=None)
    ap.add_argument("--no-verify", action="store_true",
                    help="skip golden check (NO_CORRECTNESS_CHECK knob, "
                         "Makefile:156-158)")
    ap.add_argument("--csv", default=None,
                    help="write per-call phase timings CSV")
    ap.add_argument("--prerun-check", action="store_true",
                    help="interactive Y/n gate before running (the "
                         "reference's prerun_check, utils.cpp:9-39; "
                         "skipped by default = NO_PRERUN_CHECK)")
    ap.add_argument("--roundtrip", action="store_true",
                    help="time whole calls only, no phase split (the "
                         "NO_INTERMEDIATE_RESULTS mode, Makefile:159-161)")
    args = ap.parse_args(argv)

    from .config import PLFConfig
    from .engine import PLFEngine
    from .runtime.executor import StreamingExecutor
    from .utils.timing import format_timing_table, write_csv

    if args.config:
        cfg = PLFConfig.from_name(args.config,
                                  instances=args.instances)
    else:
        cfg = PLFConfig(instances=args.instances)
    if args.block:
        cfg = __import__("dataclasses").replace(cfg,
                                                block_sites=args.block)
    import jax

    eng = PLFEngine(cfg)
    log(eng.describe(args.sites, args.calls))
    log(f"devices: {jax.devices()}")

    if args.prerun_check and sys.stdin.isatty():
        ans = input("Start the run? [Y/n] ").strip().lower()
        if ans and ans != "y":
            log("Aborted.")
            return 2

    log("Initialize test data ...")
    case = make_data(args.sites, cfg.states, cfg.categories)
    log("Running ...")
    ex = StreamingExecutor(cfg, inflight=1 if args.roundtrip else 2)
    result = None
    for result in ex.run(case for _ in range(args.calls)):
        pass
    x3, inc = result

    ok = True
    if not args.no_verify:
        log("Data collected, checking for correctness ...")
        from .runtime.native import plf_golden_native
        x3_ref, sv_ref, inc_ref = plf_golden_native(
            *case[:5], case[5], states=cfg.states,
            categories=cfg.categories)
        # The XLA op lets the compiler contract mul+add into FMA, so the
        # bar is a few ULP (engine.PLFEngine.verify), not bit equality.
        got = np.asarray(x3).reshape(x3_ref.shape)
        neq = np.abs(got - x3_ref) > np.abs(x3_ref) * 5e-7 + 1e-37
        errors = int(neq.sum())
        for site, c, a in np.argwhere(neq)[:20]:
            log(f"ERROR: alignment data wrong at alignment {site}, "
                f"probability {c * cfg.states + a}: "
                f"{x3_ref[site, c, a]}!={got[site, c, a]}")
        if inc != inc_ref:
            log(f"ERROR: scalerIncrement wrong: {inc_ref}!={inc}")
            errors += 1
        ok = errors == 0
        log(f"Test result: {'Passed' if ok else f'Failed with {errors} errors'}")

    e = cfg.elements_per_site
    data_bytes = float(args.sites) * e * 4 * 3 * args.calls
    log(format_timing_table(ex.timing, data_bytes,
                            args.sites * args.calls))
    if args.csv:
        write_csv(args.csv, {"i0": ex.timing})
        log(f"wrote {args.csv}")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
