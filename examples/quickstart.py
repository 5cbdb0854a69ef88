"""End-to-end demo: simulate -> compress -> likelihood -> optimise.

Run on CPU:  python examples/quickstart.py          (small sizes)
Run on GPU:  python examples/quickstart.py --gpu    (bigger sizes)
"""

import argparse
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--gpu", action="store_true")
    ap.add_argument("--taxa", type=int, default=12)
    ap.add_argument("--sites", type=int, default=None)
    args = ap.parse_args()

    import jax
    if not args.gpu:
        jax.config.update("jax_platforms", "cpu")
    sites = args.sites or (1_000_000 if args.gpu else 2_000)
    block = 4096 if args.gpu else 128

    from plf_tpu.config import PLFConfig
    from plf_tpu.io.alignment import compress_patterns
    from plf_tpu.models import (PhyloModel, hky85, optimize_branch_lengths,
                                random_tree, simulate_alignment)

    print(f"backend={jax.default_backend()}  taxa={args.taxa}  "
          f"sites={sites}")

    # 1. simulate an alignment under HKY85 + gamma
    tree = random_tree(args.taxa, seed=42, mean_branch=0.15)
    model = hky85(kappa=2.5, pi=[0.30, 0.20, 0.25, 0.25])
    tips = simulate_alignment(tree, model, sites, alpha=0.7, seed=1)

    # 2. compress duplicate site patterns (the RAxML wgt mechanism)
    patterns, wgt = compress_patterns(tips)
    print(f"site patterns: {sites} sites -> {patterns.shape[1]} patterns")

    # 3. whole-tree likelihood (the Triton kernel on a GPU)
    cfg = PLFConfig(block_sites=block)
    pm = PhyloModel(tree, model, patterns, wgt=wgt, alpha=0.7, config=cfg)
    t0 = time.perf_counter()
    out = pm.log_likelihood()
    dt = time.perf_counter() - t0
    print(f"log-likelihood = {out.log_likelihood:.3f}  "
          f"(path={out.method}, scalers={out.scaler_total}, "
          f"{dt*1e3:.0f} ms incl. compile)")

    # 4. optimise branch lengths on device (gradients through the PLF)
    t_opt, ll0, ll1 = optimize_branch_lengths(pm, steps=40,
                                              learning_rate=0.05)
    print(f"branch-length optimisation: {ll0:.3f} -> {ll1:.3f} "
          f"(+{ll1 - ll0:.3f})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
