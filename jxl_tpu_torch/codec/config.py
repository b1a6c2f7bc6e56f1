"""Codec configuration.

Collapses the reference's codec-variant machinery — git checkout + patch +
full C++ rebuild per A/B arm (`docker_manager.rs:303-381`, invoked from the
dispatch loop at `benchmark.rs:452-484`) — into one enum field: the thesis's
three proposal diffs (`proposals/*.diff`) become selectable strategies of a
single engine, matching the activation matrix in SURVEY §2.4:

| Strategy                      | Hook A (partition override) | Hook B (entropy factor) |
|-------------------------------|-----------------------------|-------------------------|
| BASELINE                      | off                         | off                     |
| HOMOGENEITY_PARTITIONING      | on                          | off                     |
| HOMOGENEITY_FACTORED_ENTROPY  | off                         | on                      |
| COMBINED                      | on                          | on                      |
"""

from __future__ import annotations

import enum
from dataclasses import dataclass


class Strategy(enum.Enum):
    BASELINE = 0
    HOMOGENEITY_PARTITIONING = 1
    HOMOGENEITY_FACTORED_ENTROPY = 2
    COMBINED = 3
    # Round-5 thesis follow-up (VERDICT r4 item 9): the 600-point A/B
    # found Hook A pays only where the dense search's candidates are
    # near-TIED in proxy rate (the case the proxy can't rank). This
    # variant applies the homogeneity override ONLY on near-ties
    # (strategy/acs.py, JXL_TPU_HOOKA_EPS) — a modernized form of the
    # thesis heuristic as a tie-breaker instead of an unconditional
    # override.
    HOMOGENEITY_RD_GATED = 4

    @property
    def hook_a(self) -> int:
        """Hook A level: 0 off, 1 unconditional override of plain-DCT
        winners via HomogeneityPartition
        (homogeneity-partitioning.diff:272-277), 2 near-tie-gated
        (HOMOGENEITY_RD_GATED). Truthy exactly when the hook runs, so
        existing boolean call sites keep working."""
        if self is Strategy.HOMOGENEITY_RD_GATED:
            return 2
        return (
            1
            if self in (Strategy.HOMOGENEITY_PARTITIONING, Strategy.COMBINED)
            else 0
        )

    @property
    def hook_b(self) -> bool:
        """Scale RD cost by 0.8 * avg(r_h, r_v, r_d) inside entropy estimation
        (homogeneity-factored-entropy.diff:248-254)."""
        return self in (Strategy.HOMOGENEITY_FACTORED_ENTROPY, Strategy.COMBINED)


@dataclass(frozen=True)
class CodecConfig:
    """Codec parameters (frozen and hashable, like the reference's)."""

    distance: float = 1.0  # butteraugli-target-style quality knob (cjxl --distance)
    effort: int = 7  # cjxl --effort analog: see the effort ladder below
    strategy: Strategy = Strategy.BASELINE
    lanes: int = 256  # interleaved rANS streams
    epf: bool = True  # decode-side edge-preserving filter (signaled in header)
    # Allow the per-image VarDCT-vs-modular mode decision on candidate
    # content (codec/encode._pick_mode). The striped gigapixel encoder
    # turns it off per stripe: sections of one JXTS container must agree
    # on the coding family for the plane-space stitch.
    modular: bool = True

    # Effort semantics (single source of truth: codec/encode.tokens_from_rgb
    # gates + strategy/acs.MERGE_LADDER minimum efforts):
    #   e1 fixed 8x8, no CfL/adaptive-quant, fixed gradient DC predictor
    #   e2 + adaptive DC predictor search
    #   e3 + chroma-from-luma + adaptive quant field
    #   e4 + sub-8x8 AC-strategy search (8x8/4x4/8x4/4x8)
    #   e5 + RDO quantization
    #   e6 + 16x16 merges        e7 + 32x32/64x64
    #   e8 + two-pass measured-rate ACS/RDO
    #   e9 + 128x128/256x256
