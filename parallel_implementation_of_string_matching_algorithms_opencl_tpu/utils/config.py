"""Framework configuration (SURVEY.md §5 "Config / flag system").

The reference's config surface is ``argv`` positional args; ours is a small
frozen dataclass that the CLI maps onto.  No heavyweight config framework.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class MatchConfig:
    """Knobs for a match run.  All fields are static (affect compilation)."""

    # Offset-buffer capacity per call/shard (counts stay exact on overflow).
    capacity: int = 65536
    # Candidate-verification gather capacity (RK screen / BM filter).
    verify_capacity: int = 131072
    # Lane chunk length for the KMP DFA scan (smaller = more lanes).
    kmp_chunk: int = 2048
    # Lane chunk length for the honest BM cursor variant.
    bm_chunk: int = 4096
    # 'filtered' (vectorized screen+verify, default) or 'cursor' (skip loop).
    bm_variant: str = "filtered"
    # Pad text length to a multiple of this, so nearby lengths share one
    # compiled executable.
    pad_multiple: int = 4096
    # Rabin-Karp base override (odd uint32); None = ops.tables.RK_BASE.
    rk_base: int | None = None
    # Distributed offset merge: 'count_sized' (default) runs the scan +
    # psum/pmax stats first, then gathers offset buffers sized to the
    # next power of two >= the LARGEST per-shard count — collective
    # traffic scales with the result, not with capacity.  'fixed' keeps
    # the single-dispatch capacity-sized all_gather (wins when results
    # ~always fill capacity, or when the extra dispatch round-trip
    # dominates, e.g. tiny texts).
    dist_gather: str = "count_sized"

    def __post_init__(self):
        if self.pad_multiple < 1:
            raise ValueError(
                f"pad_multiple must be positive, got {self.pad_multiple}"
            )

    def replace(self, **kw) -> "MatchConfig":
        return dataclasses.replace(self, **kw)


DEFAULT_CONFIG = MatchConfig()
