"""plf_tpu — a phylogenetic likelihood engine in JAX for NVIDIA GPUs.

A ground-up JAX re-design of the capabilities of
GeertRoks/AMD-Versal-phylogenetic-likelihood-function (an AMD Versal
AIE/PL accelerator for the RAxML ``newviewGAMMA`` PLF kernel): the PLF
node and whole-tree traversals as compiled XLA programs, a whole-tree
Pallas kernel through Triton for DNA, site-sharded multi-device scaling
via ``shard_map``, substitution models, search and fitting, and the
reference's verification methodology as pytest suites.
"""

from .config import PLFConfig, Layout, AieType, Backend, DNA, PROTEIN
from .reference import plf_reference, MIN_LIKELIHOOD, TWO_TO_THE_32
from .engine import PLFEngine, plf

__version__ = "0.1.0"
