"""Matcher model base: pattern precompute + jitted device execution + results.

This layer plays the role of the reference's per-algorithm host driver
(SURVEY.md component R5) — but where the OpenCL driver hand-manages contexts,
queues, buffers and NDRange launches, here XLA/PJRT does all of that: a
matcher is (host-side table precompute) + (one jitted function from byte
tensors to fixed-capacity match results).
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from ..ops import emit
from ..utils.config import DEFAULT_CONFIG, MatchConfig
from ..utils.io import as_byte_array, pad_to_multiple
from .backend import execution_path


def valid_prefix(off: np.ndarray) -> np.ndarray:
    """Ascending valid prefix of a FILL-padded offset buffer: stop at the
    first hole (negative entry), so ``offsets`` is always a true prefix
    of the global ascending match set."""
    bad = np.nonzero(off < 0)[0]
    return off[: bad[0]] if bad.size else off


@dataclasses.dataclass
class MatchResult:
    """Host-facing result: exact count and sorted 0-based byte offsets.

    ``offsets`` is an ascending PREFIX of the real match set (overlapping
    occurrences included).  If ``overflow`` is True the prefix is
    incomplete — ``count`` is still exact but ``offsets`` holds only the
    first ``len(offsets)`` matches (at most ``capacity``).  ``match_all`` /
    ``drain=True`` recovers every offset.
    """

    algo: str
    pattern: bytes
    n: int
    count: int
    offsets: np.ndarray
    overflow: bool

    def offsets_list(self) -> list[int]:
        return [int(x) for x in self.offsets]


class Matcher:
    """Base matcher: subclass with ``name``, ``_precompute`` and
    ``_mask``."""

    name = "base"

    def __init__(self, pattern: bytes, config: MatchConfig = DEFAULT_CONFIG):
        if len(pattern) == 0:
            raise ValueError("empty pattern")
        self.pattern_bytes = bytes(pattern)
        self.m = len(pattern)
        pat = np.frombuffer(self.pattern_bytes, dtype=np.uint8)
        self.config = config
        self.pattern_arr = pat
        self.tables = self._precompute(pat)

    # -- subclass hooks -----------------------------------------------------

    def _precompute(self, pat: np.ndarray) -> dict:
        """Host-side table precompute; returns a dict of numpy arrays that is
        passed into the jitted function as a pytree (so matchers with the
        same pattern length share one compiled executable)."""
        return {}

    @staticmethod
    def _mask(text, pattern, tables, config: MatchConfig):
        """Traced start-mask computation (plain ``jax.numpy``); must be
        overridden."""
        raise NotImplementedError

    @classmethod
    def _start_mask(cls, text, pattern, tables, config: MatchConfig):
        """The start mask on the path models/backend chooses."""
        execution_path()
        return cls._mask(text, pattern, tables, config)

    # -- execution ----------------------------------------------------------

    _jit_cache: dict = {}

    @classmethod
    def _runner(cls, config: MatchConfig):
        key = (cls, config)
        fn = Matcher._jit_cache.get(key)
        if fn is None:

            def run(text, n, pattern, tables):
                mask = cls._start_mask(text, pattern, tables, config)
                mask = emit.valid_start_mask(mask, n, pattern.shape[0])
                return emit.mask_to_matches(mask, config.capacity)

            fn = jax.jit(run)
            Matcher._jit_cache[key] = fn
        return fn

    def start_mask(self, text: jnp.ndarray) -> jnp.ndarray:
        """Raw traced mask (testing hook) — no validity trimming."""
        return type(self)._start_mask(
            text, jnp.asarray(self.pattern_arr),
            jax.tree.map(jnp.asarray, self.tables), self.config,
        )

    def match_all(self, data) -> MatchResult:
        """Like ``match`` but guarantees EVERY offset is returned even when
        the count exceeds ``config.capacity`` (SURVEY.md §7.3 stage 2's
        documented escape hatch for one-pass padded emission).

        Overflow drain by windowed re-extraction: re-run the matcher over
        windows of the text, each read with an (m-1)-byte halo.  The
        per-window validity limit p <= len(window)-m is exactly
        start-ownership (the streaming driver's identity), so the
        concatenation is duplicate-free and ascending.  The window size is
        derived from the exact global count (exact even on overflow):
        ~capacity/2 expected matches per window, so the drain costs
        ~2·count/capacity dispatches — not O(n/capacity) blind walking.  A
        window that still overflows (locally dense matches) splits in half
        until it fits; a
        ``capacity``-byte window holds at most ``capacity`` start positions
        and therefore always terminates the recursion.
        """
        arr = as_byte_array(data)
        res = self.match(arr)
        if not res.overflow:
            return res
        offsets = self.extract_range(arr, 0, len(arr), res.count)
        assert len(offsets) == res.count
        return dataclasses.replace(res, offsets=offsets, overflow=False)

    def extract_range(self, arr: np.ndarray, lo: int, hi: int,
                      est: int) -> np.ndarray:
        """EVERY match offset starting in ``[lo, hi)``, by windowed
        re-extraction (the drain engine behind ``match_all``; the
        distributed drains reuse it per overflowing shard/host range).
        Each window reads (m-1) halo bytes past its end, so the
        per-window validity limit p <= len(window)-m is exactly
        start-ownership and the concatenation is duplicate-free and
        ascending.  ``est``: expected match count in the range (sizes
        windows at ~capacity/2 expected matches — ~2·est/capacity
        dispatches, not O(range/capacity) blind walking)."""
        cap = self.config.capacity
        pm = max(1, self.config.pad_multiple)
        span = hi - lo
        if span <= 0:
            return np.empty(0, np.int64)
        est = max(1, est)
        W = int(max(cap, min(span, span * cap // (2 * est) + 1)))
        W = -(-W // pm) * pm  # shape reuse across windows

        parts = []

        def drain(wlo: int, w: int) -> None:
            sub = arr[wlo : wlo + w + self.m - 1]
            r = self.match(sub)
            if not r.overflow:
                if r.count:
                    offs = np.asarray(r.offsets, np.int64)
                    parts.append(offs[offs >= 0] + wlo)
                return
            assert w > cap, "capacity-byte window overflowed"
            half = -(-(w // 2) // pm) * pm
            if half >= w:
                half = w // 2
            drain(wlo, half)
            drain(wlo + half, w - half)

        for wlo in range(lo, hi, W):
            drain(wlo, min(W, hi - wlo))
        return (
            np.concatenate(parts) if parts else np.empty(0, np.int64)
        )

    def match(self, data) -> MatchResult:
        arr = as_byte_array(data)
        n = len(arr)
        padded = pad_to_multiple(arr, self.config.pad_multiple)
        count, offsets, overflow = self._runner(self.config)(
            jnp.asarray(padded),
            jnp.int32(n),
            jnp.asarray(self.pattern_arr),
            self.tables,
        )
        count = int(count)
        kept = min(count, self.config.capacity)
        offs = valid_prefix(np.asarray(offsets)[:kept])
        return MatchResult(
            algo=self.name,
            pattern=self.pattern_bytes,
            n=n,
            count=count,
            offsets=offs,
            overflow=bool(overflow) or len(offs) < count,
        )
