"""Configuration system for the PLF engine.

The reference accelerator exposes one orthogonal config algebra spread over
three binding times (Makefile variables composing the build name, the
xclbin *filename* re-parsed at runtime, and argv — see
``/root/reference/Makefile:14-41`` and ``app/src/include.h:39-75``).  Here the
same axes collapse into a single runtime dataclass:

  =====================  ============================  =======================
  Reference knob         Where it lived                Equivalent here
  =====================  ============================  =======================
  STATES (DNA/AA)        Makefile STATES               ``states``
  WINDOW_SIZE            AIE window bytes              ``block_sites`` (site
                                                       padding unit)
  AIE_TYPE window/stream window re-send vs stream      (kept for the io
                                                       compat layer)
  PLIO_LAYOUT Comb/Sep   header packing layout         ``layout`` (io packing)
  NUM_ACCELERATORS       9 parallel graph instances    ``instances`` (vmap) /
                                                       mesh data parallelism
  TARGET sw_emu/hw       emulation ladder              ``interpret`` (Pallas
                                                       interpreter for the
                                                       whole-tree kernel)
  =====================  ============================  =======================

The "filename-as-config" codec (`to_name`/`from_name`) round-trips a config
through a reference-style name string for CSV/bench parity
(``include.h:118-146`` parses names like ``plf_mem4window_128x9...``).
"""

from __future__ import annotations

import dataclasses
import re
from enum import Enum


class Layout(Enum):
    """Input-buffer packing layout (io compat layer only).

    COMBINED ("1inEV"): EV + branch prepended to both child buffers.
    SEPARATE ("2in"):   EV only on the left buffer.
    See app/src/include.h:52-59, 207-236.
    """

    COMBINED = "combined"
    SEPARATE = "separate"


class AieType(Enum):
    """Streaming discipline of the reference dataflow (io compat only)."""

    WINDOW = "window"
    STREAM = "stream"


class Backend(Enum):
    """Which compute path evaluates the PLF."""

    PALLAS = "pallas"   # the whole-tree Pallas kernel where it applies
    XLA = "xla"         # XLA paths only
    REFERENCE = "reference"  # NumPy golden model (host; testing only)


@dataclasses.dataclass(frozen=True)
class PLFConfig:
    """One config object for the whole engine."""

    states: int = 4            # 4 = DNA, 20 = protein
    categories: int = 4        # gamma rate categories
    block_sites: int = 4096    # site padding unit (the "window size" analogue)
    instances: int = 1         # independent node-pairs batched per call
    layout: Layout = Layout.COMBINED
    aie_type: AieType = AieType.WINDOW
    backend: Backend = Backend.PALLAS
    interpret: bool = False    # run the whole-tree kernel in the Pallas
                               # interpreter (the sw_emu analogue; tests)
    dtype: str = "float32"     # CLV storage: "float32" or "bfloat16"
                               # (fast mode; arithmetic stays fp32)
    tip_dtype: str = "int32"   # tip state-code storage: "int32" or "int8"
                               # (codes are the whole-tree kernel's only
                               # per-site input stream — int8 quarters
                               # it; values fit easily: S + gap +
                               # ambiguity <= 24 codes even for protein)
    kernel_variant: str = "vpu"  # how the node's stages 1 and 3 run
                                 # (ops/plf_xla.py): "vpu" (element-wise
                                 # sums in the golden model's order),
                                 # "mxu" (dots at the F32_F32_F32 dot
                                 # algorithm), "mxu_3x" (BF16_BF16_F32_X3,
                                 # ~1e-5 relative), "mxu_bf16"
                                 # (BF16_BF16_F32; near-underflow sites
                                 # can round negative through deep trees
                                 # and land on the log floor — forward
                                 # only), or "auto" (vpu for small state
                                 # counts, mxu_3x for S >= 20)

    def __post_init__(self):
        if self.states < 2:
            raise ValueError(f"states must be >= 2, got {self.states}")
        if self.categories < 1:
            raise ValueError(f"categories must be >= 1, got {self.categories}")
        if self.block_sites < 128 or self.block_sites % 128:
            # the padding unit: a multiple of 128 keeps every power-of-two
            # kernel block up to 128 sites a divisor of the padded count
            raise ValueError(
                f"block_sites must be a positive multiple of 128, got "
                f"{self.block_sites}")
        if self.dtype not in ("float32", "bfloat16"):
            raise ValueError(f"unsupported dtype {self.dtype!r}")
        if self.tip_dtype not in ("int32", "int8"):
            raise ValueError(f"unsupported tip_dtype {self.tip_dtype!r}")
        if self.kernel_variant not in ("vpu", "mxu", "mxu_3x", "mxu_bf16",
                                       "auto"):
            raise ValueError(
                f"unsupported kernel_variant {self.kernel_variant!r}")

    @property
    def resolved_kernel_variant(self) -> str:
        """Resolve "auto": the element-wise form for small state counts
        (DNA); the dot form at BF16_BF16_F32_X3 (~1e-5 relative, fp32
        grade) once the (S, S) operators are large enough for the dots
        to carry the work (S >= 20; the element-wise form unrolls S^2
        products per category).  Set kernel_variant="mxu" for the full
        fp32 dot algorithm."""
        if self.kernel_variant != "auto":
            return self.kernel_variant
        return "vpu" if self.states <= 8 else "mxu_3x"

    @property
    def elements_per_site(self) -> int:
        """Floats per alignment site (include.h:153: 16 for DNA)."""
        return self.states * self.categories

    @property
    def rows(self) -> int:
        """Rows of the canonical lane-major CLV layout."""
        return self.states * self.categories

    # -- filename-as-config codec (reference parity) -------------------------

    def to_name(self) -> str:
        """Serialise to an unambiguous config-name string.

        Plays the role of the reference's filename-as-config (the xclbin
        name is re-parsed at runtime, include.h:41-75) with explicit
        tokens instead of the reference's positional encoding.
        """
        st = "DNA" if self.states == 4 else f"{self.states}state"
        layout = "1inEV" if self.layout is Layout.COMBINED else "2in"
        return (f"plftpu_{st}_{self.aie_type.value}_{layout}"
                f"_{self.backend.value}_inst{self.instances}"
                f"_blk{self.block_sites}")

    @classmethod
    def from_name(cls, name: str, **overrides) -> "PLFConfig":
        """Parse a config name — ours or a reference-style xclbin name.

        Reference names look like ``<app>_<pl>_128x<G><STATES><type>
        <windowbytes><layout>`` (README.md:94-99); their window sizes are
        BYTES and convert to sites via >>4 (include.h:156), then round to
        the 128-site padding unit.  Both reference naming generations are
        understood: Comb==1inEV -> COMBINED, Sep==2in -> SEPARATE
        (include.h:52-59; SURVEY.md §2.3).
        """
        aie_type = AieType.STREAM if "stream" in name else AieType.WINDOW
        if "1inEV" in name or "Comb" in name:
            layout = Layout.COMBINED
        elif "2in" in name or "Sep" in name:
            layout = Layout.SEPARATE
        else:
            layout = Layout.SEPARATE  # reference default (include.h:58)

        mb = re.search(r"blk(\d+)", name)
        if mb:
            block = int(mb.group(1))
        else:
            mw = re.search(r"(?:window|stream)(\d\d+)", name)
            if mw:  # reference window size in bytes -> sites (>>4)
                sites = int(mw.group(1)) >> 4
                block = max(128, sites // 128 * 128)
            else:
                block = 4096

        states = 4
        ms = re.search(r"(\d+)state", name)
        if ms:
            states = int(ms.group(1))

        mi = re.search(r"inst(\d+)", name) or re.search(r"128x(\d+)", name)
        instances = int(mi.group(1)) if mi else 1

        backend = Backend.PALLAS
        for b in Backend:
            if f"_{b.value}" in name:
                backend = b
                break
        kw = dict(states=states, block_sites=block, instances=instances,
                  layout=layout, aie_type=aie_type, backend=backend)
        kw.update(overrides)
        return cls(**kw)


DNA = PLFConfig(states=4)
PROTEIN = PLFConfig(states=20, kernel_variant="auto")
