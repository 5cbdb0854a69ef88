"""Full ML inference demo: simulate, infer, and compare to the truth.

Exercises the complete RAxML-shaped workflow on the device engine
(models/pipeline.run_inference): pattern compression, device-side JC
distances + NJ starting tree, NNI topology search on the whole-tree
likelihood, branch-length/alpha fitting, distance-bootstrap
support, and SH-like aLRT branch support.

    python examples/full_inference.py [--taxa 12] [--sites 5000]
"""

import argparse
import sys

import numpy as np


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--taxa", type=int, default=12)
    ap.add_argument("--sites", type=int, default=5000)
    ap.add_argument("--bootstrap", type=int, default=20)
    args = ap.parse_args()

    from plf_tpu.models import (alrt_support, annotate_alrt, hky85,
                                random_tree, rf_distance, run_inference,
                                simulate_alignment)

    true_tree = random_tree(args.taxa, seed=7, mean_branch=0.1)
    model = hky85(2.0)
    codes = simulate_alignment(true_tree, model, args.sites, alpha=0.6,
                               seed=8)
    print(f"simulated {args.taxa} taxa x {args.sites} sites "
          f"(HKY85+G, true tree hidden)")

    res = run_inference(codes, names=true_tree.leaf_names(), model=model,
                        alpha=0.6, search="nni", fit="lengths+alpha",
                        bootstrap=args.bootstrap, progress=print)
    print(f"\ninferred ll = {res.log_likelihood:.3f}, "
          f"alpha = {res.alpha:.3f}, {res.elapsed_s:.1f}s")
    print(f"RF distance to true tree: {rf_distance(res.tree, true_tree)}")

    # SH-like branch support on the inferred topology.
    order = {nm: i for i, nm in enumerate(true_tree.leaf_names())}
    tips = codes[[order[nm] for nm in res.tree.leaf_names()]]
    sup = alrt_support(res.tree, model, tips, alpha=res.alpha,
                       rell_replicates=500)
    ann = annotate_alrt(res.tree, sup)
    print("\nSH-aLRT annotated tree:")
    print(ann.to_newick())
    return 0


if __name__ == "__main__":
    sys.exit(main())
