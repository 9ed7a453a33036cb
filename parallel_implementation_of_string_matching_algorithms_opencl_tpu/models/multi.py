"""Multi-pattern matching (BASELINE config 2: RK over 8 patterns).

Rabin-Karp is the natural multi-pattern algorithm here: the window hash is
computed once per text position and compared against k scalar pattern hashes.
Patterns must share a length within one matcher; the API layer groups
arbitrary pattern sets by length and runs one matcher per group.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from ..ops import emit
from ..ops import rabin_karp as rk_ops
from ..ops import tables
from ..utils.config import DEFAULT_CONFIG, MatchConfig
from ..utils.io import as_byte_array, pad_to_multiple
from .backend import execution_path
from .base import MatchResult, valid_prefix


class RabinKarpMultiMatcher:
    """k equal-length patterns, one shared hash pass."""

    name = "rabin_karp_multi"

    _jit_cache: dict = {}

    def __init__(self, patterns: list[bytes], config: MatchConfig = DEFAULT_CONFIG):
        if not patterns:
            raise ValueError("no patterns")
        lengths = {len(p) for p in patterns}
        if len(lengths) != 1:
            raise ValueError(
                f"RabinKarpMultiMatcher needs equal-length patterns, got {lengths}"
            )
        if 0 in lengths:
            raise ValueError("empty pattern")
        self.patterns = [bytes(p) for p in patterns]
        self.m = len(self.patterns[0])
        self.k = len(self.patterns)
        self.config = config
        consts = tables.rk_constants(self.m, config.rk_base)
        self.pattern_arr = np.stack(
            [np.frombuffer(p, dtype=np.uint8) for p in self.patterns]
        )
        self.tables = {
            "powers": consts["powers"],
            "hashes": np.array(
                [tables.rk_hash(p, consts) for p in self.patterns], dtype=np.uint32
            ),
        }

    @classmethod
    def _runner(cls, config: MatchConfig, k: int):
        key = (cls, config, k)
        fn = cls._jit_cache.get(key)
        if fn is None:

            def run(text, n, patterns, tables_):
                masks = cls._multi_masks(text, patterns, tables_, config)
                m = patterns.shape[1]
                counts, offsets, overflows = [], [], []
                for p in range(k):
                    mask = emit.valid_start_mask(masks[p], n, m)
                    c, o, v = emit.mask_to_matches(mask, config.capacity)
                    counts.append(c)
                    offsets.append(o)
                    overflows.append(v)
                return (
                    jnp.stack(counts),
                    jnp.stack(offsets),
                    jnp.stack(overflows),
                )

            fn = jax.jit(run)
            cls._jit_cache[key] = fn
        return fn

    @staticmethod
    def _multi_masks(text, patterns, tables_, config: MatchConfig):
        """bool[k, N] exact start masks — the shared-hash pass
        (ops/rabin_karp.rk_multi_start_masks) on the path models/backend
        chooses."""
        execution_path()
        return rk_ops.rk_multi_start_masks(
            text,
            patterns,
            tables_["powers"],
            tables_["hashes"],
            config.verify_capacity,
        )

    def match(self, data) -> list[MatchResult]:
        arr = as_byte_array(data)
        n = len(arr)
        padded = pad_to_multiple(arr, self.config.pad_multiple)
        counts, offsets, overflows = self._runner(self.config, self.k)(
            jnp.asarray(padded),
            jnp.int32(n),
            jnp.asarray(self.pattern_arr),
            self.tables,
        )
        counts = np.asarray(counts)
        offsets = np.asarray(offsets)
        overflows = np.asarray(overflows)
        out = []
        for p in range(self.k):
            c = int(counts[p])
            kept = min(c, self.config.capacity)
            offs = valid_prefix(offsets[p][:kept])
            out.append(
                MatchResult(
                    algo=self.name,
                    pattern=self.patterns[p],
                    n=n,
                    count=c,
                    offsets=offs,
                    overflow=bool(overflows[p]) or len(offs) < c,
                )
            )
        return out
