"""Parallel exact string matching in JAX, on one GPU, a mesh or a stream.

A from-scratch JAX/XLA re-design of the capability surface of the
OpenCL reference `AnupBS28/PARALLEL_IMPLEMENTATION_OF_STRING_MATCHING_ALGORITHMS_OPENCL`
(see SURVEY.md at the repository root — the reference sources were not
available when it was written, so parity is pinned to the task statement
in BASELINE.json and the conformance oracle, not to reference file:line
cites).

Four exact-matching algorithm families, all producing byte-identical sorted
0-based match offsets (overlapping occurrences included):

- ``naive``        — vectorized shift-AND window compare
- ``rabin_karp``   — wrapping-mod-2**32 polynomial window hash + exact verify,
                     multi-pattern capable
- ``kmp``          — branchless dense-DFA automaton scan, lane-parallel chunks
- ``boyer_moore``  — bad-char + good-suffix tables; the default execution
                     is a probe-screen + verify pipeline (the vector
                     translation of BM's skip loop) with exact parity

Parallel decomposition: text sharded over a 1-D ``data`` mesh axis with
(pattern_len-1)-byte halo overlap at shard boundaries; pattern and precomputed
tables replicated; per-shard counts merged via ``psum`` and offsets via
fixed-capacity ``all_gather`` (BASELINE.json:5).
"""

from .api import match, match_distributed, MatchResult, available_algorithms
from .models.base import Matcher
from .models.registry import get_matcher, register_matcher
from .parallel.multihost import match_multihost, match_multihost_streaming
from .parallel.streaming import match_stream
from .utils.config import MatchConfig

__version__ = "0.1.0"

__all__ = [
    "match",
    "match_distributed",
    "match_multihost",
    "match_multihost_streaming",
    "match_stream",
    "MatchResult",
    "Matcher",
    "MatchConfig",
    "get_matcher",
    "register_matcher",
    "available_algorithms",
    "__version__",
]
