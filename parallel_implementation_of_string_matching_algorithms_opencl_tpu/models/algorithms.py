"""Concrete matcher models: naive, Rabin-Karp, KMP, Boyer-Moore.

Each model = host table precompute (ops/tables) + a traced mask function
(ops/<algo>).  All four produce byte-identical start masks; they are
benchmarked separately (BASELINE.json:2 "bytes/s/chip per algorithm").
"""

from __future__ import annotations

import numpy as np

from ..ops import boyer_moore as bm_ops
from ..ops import kmp as kmp_ops
from ..ops import naive as naive_ops
from ..ops import rabin_karp as rk_ops
from ..ops import tables
from ..utils.config import MatchConfig
from .base import Matcher
from .registry import register_matcher


@register_matcher
class NaiveMatcher(Matcher):
    """Vectorized shifted-compare window match (SURVEY.md R1)."""

    name = "naive"

    @staticmethod
    def _mask(text, pattern, tables_, config: MatchConfig):
        return naive_ops.naive_start_mask(text, pattern)


@register_matcher
class RabinKarpMatcher(Matcher):
    """Wrapping-mod-2**32 polynomial hash screen + exact verify (SURVEY.md R2).

    The shift-chain hash (ops/rabin_karp.py) also serves the multi-pattern
    shared-hash path (models/multi.py).
    """

    name = "rabin_karp"

    def _precompute(self, pat: np.ndarray) -> dict:
        c = tables.rk_constants(len(pat), self.config.rk_base)
        return {
            "powers": c["powers"],
            "pattern_hash": tables.rk_hash(pat, c),
        }

    @staticmethod
    def _mask(text, pattern, tables_, config: MatchConfig):
        return rk_ops.rk_start_mask(
            text,
            pattern,
            tables_["powers"],
            tables_["pattern_hash"],
            config.verify_capacity,
        )


@register_matcher
class KMPMatcher(Matcher):
    """Branchless prefix-automaton scan (SURVEY.md R3, R8): the dense-DFA
    ``state = dfa[state, byte]`` automaton in parallel lanes
    (ops/kmp.py)."""

    name = "kmp"

    def _precompute(self, pat: np.ndarray) -> dict:
        return {"dfa": tables.kmp_dfa(pat)}

    @staticmethod
    def _mask(text, pattern, tables_, config: MatchConfig):
        return kmp_ops.kmp_start_mask(text, tables_["dfa"], config.kmp_chunk)


@register_matcher
class BoyerMooreMatcher(Matcher):
    """Bad-char + good-suffix Boyer-Moore (SURVEY.md R4, R10).

    ``config.bm_variant`` selects the vectorized filter+verify pipeline
    ('filtered', default) or the faithful lane-cursor skip loop ('cursor').
    """

    name = "boyer_moore"

    def _precompute(self, pat: np.ndarray) -> dict:
        return {
            "bad_char": tables.bm_bad_char(pat),
            "good_suffix": tables.bm_good_suffix(pat),
        }

    @staticmethod
    def _mask(text, pattern, tables_, config: MatchConfig):
        if config.bm_variant == "cursor":
            return bm_ops.bm_start_mask_cursor(
                text,
                pattern,
                tables_["bad_char"],
                tables_["good_suffix"],
                config.bm_chunk,
            )
        return bm_ops.bm_start_mask_filtered(
            text, pattern, config.verify_capacity
        )
