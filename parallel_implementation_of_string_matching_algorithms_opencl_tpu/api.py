"""Top-level user API.

``match(text, pattern, algo=...)`` is the single-device entry point
(SURVEY.md §3.2); ``match_distributed`` shards the text over a device mesh
with halo overlap (SURVEY.md §3.3).  Matchers are cached per
(algo, pattern, config) so repeated calls hit XLA's compilation cache.

Algorithm choice: all four return identical results.  ``rabin_karp``
shares one hash pass across a LIST of equal-length patterns.  Their speeds
on the card are recorded in PERF.md.
"""

from __future__ import annotations

from .models.base import Matcher, MatchResult
from .models.multi import RabinKarpMultiMatcher
from .models.registry import available_algorithms, get_matcher
from .utils.config import DEFAULT_CONFIG, MatchConfig

_matcher_cache: dict = {}


def _get_cached_matcher(algo: str, pattern: bytes, config: MatchConfig) -> Matcher:
    key = (algo, pattern, config)
    m = _matcher_cache.get(key)
    if m is None:
        m = get_matcher(algo)(pattern, config)
        _matcher_cache[key] = m
    return m


def _coerce_pattern(pattern) -> bytes:
    if isinstance(pattern, str):
        return pattern.encode("utf-8")
    return bytes(pattern)


def match(
    text,
    pattern,
    algo: str = "boyer_moore",
    config: MatchConfig | None = None,
    drain: bool = False,
    **overrides,
):
    """Exact match: all (overlapping) occurrences as sorted 0-based offsets.

    ``pattern`` may be bytes/str, or a list of them — a list dispatches to
    the multi-pattern path (shared Rabin-Karp hash pass for equal-length
    groups when ``algo`` is 'rabin_karp'; otherwise one run per pattern) and
    returns a list of MatchResult in input order.

    ``drain=True`` guarantees every offset is returned even past
    ``capacity`` (windowed re-extraction — see Matcher.match_all); counts
    are exact either way.
    """
    cfg = (config or DEFAULT_CONFIG).replace(**overrides) if overrides else (
        config or DEFAULT_CONFIG
    )
    if isinstance(pattern, (list, tuple)):
        return _match_many(
            text, [_coerce_pattern(p) for p in pattern], algo, cfg, drain
        )
    m = _get_cached_matcher(algo, _coerce_pattern(pattern), cfg)
    return m.match_all(text) if drain else m.match(text)


def _match_many(text, patterns: list[bytes], algo: str, cfg: MatchConfig,
                drain: bool = False):
    def one(p: bytes) -> MatchResult:
        m = _get_cached_matcher(algo, p, cfg)
        return m.match_all(text) if drain else m.match(text)

    if get_matcher(algo).name == "rabin_karp" and not drain:
        # Group equal-length patterns into shared-hash-pass matchers.
        # (drain=True runs per-pattern so the windowed re-extraction
        # guarantee applies to every pattern.)
        by_len: dict[int, list[int]] = {}
        for i, p in enumerate(patterns):
            by_len.setdefault(len(p), []).append(i)
        results: list[MatchResult | None] = [None] * len(patterns)
        for idxs in by_len.values():
            group = [patterns[i] for i in idxs]
            if len(group) == 1:
                results[idxs[0]] = one(group[0])
            else:
                for i, r in zip(idxs, RabinKarpMultiMatcher(group, cfg).match(text)):
                    results[i] = r
        return results
    return [one(p) for p in patterns]


def match_distributed(
    text,
    pattern,
    algo: str = "boyer_moore",
    config: MatchConfig | None = None,
    mesh=None,
    drain: bool = False,
    **overrides,
):
    """Mesh-sharded match (data-parallel with (m-1)-byte halos).  See
    parallel/dist.py for the decomposition.

    ``pattern`` may be a list: equal-length groups run ONE shared
    Rabin-Karp hash pass per shard when ``algo`` is 'rabin_karp'
    (DistributedMultiMatcher); otherwise one sharded run per pattern.
    Returns a list of MatchResult in input order for list input.

    ``drain=True`` guarantees every offset even past per-shard capacity:
    incomplete shards are re-extracted host-side over their owned ranges
    (DistributedMatcher.match_all); counts are exact either way.
    """
    from .parallel.dist import DistributedMatcher, DistributedMultiMatcher

    cfg = (config or DEFAULT_CONFIG).replace(**overrides) if overrides else (
        config or DEFAULT_CONFIG
    )

    def run(dm):
        return dm.match_all(text) if drain else dm.match(text)

    if isinstance(pattern, (list, tuple)):
        patterns = [_coerce_pattern(p) for p in pattern]
        results: list[MatchResult | None] = [None] * len(patterns)
        if get_matcher(algo).name == "rabin_karp":
            by_len: dict[int, list[int]] = {}
            for i, p in enumerate(patterns):
                by_len.setdefault(len(p), []).append(i)
            for idxs in by_len.values():
                if len(idxs) > 1:
                    dm = DistributedMultiMatcher(
                        [patterns[i] for i in idxs], config=cfg, mesh=mesh
                    )
                    for i, r in zip(idxs, run(dm)):
                        results[i] = r
                else:
                    results[idxs[0]] = run(DistributedMatcher(
                        patterns[idxs[0]], algo=algo, config=cfg, mesh=mesh
                    ))
            return results
        return [
            run(DistributedMatcher(p, algo=algo, config=cfg, mesh=mesh))
            for p in patterns
        ]
    dm = DistributedMatcher(_coerce_pattern(pattern), algo=algo, config=cfg, mesh=mesh)
    return run(dm)


__all__ = [
    "match",
    "match_distributed",
    "MatchResult",
    "available_algorithms",
]
