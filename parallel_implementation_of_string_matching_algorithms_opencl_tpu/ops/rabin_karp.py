"""Rabin-Karp (polynomial window hash) matcher op — jnp compute path.

JAX redesign of the reference's Rabin-Karp OpenCL kernel (SURVEY.md
component R2).  Design decisions (SURVEY.md §7.3 stage 5, hard part #3 —
no 64-bit integer arithmetic in the inner loop):

- Modulus is 2**32: uint32 multiply/add wraparound IS the mod, so the inner
  loop has zero explicit modular-reduction cost.
- The window hash H[i] = sum_j text[i+j] * B**(m-1-j) (mod 2**32) is computed
  as m fused multiply-accumulate passes over shifted views — the same
  shift-chain shape as the naive op, so XLA fuses it into one pass.
- Multi-pattern is where RK pays off: the hash is computed ONCE and compared
  against k scalar pattern hashes (k=8 in BASELINE config 2), vs k*m compare
  passes for naive.
- Hash equality is a screen, not an answer: candidates are exactly verified.
  The common case (few candidates) verifies via a fixed-capacity gather of
  candidate windows; the overflow case (pathological, e.g. huge true match
  count) falls back to a full naive verify under ``lax.cond``.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from . import vma

from .emit import masked_positions, tiered_by_count
from .naive import naive_start_mask

# Capacity of the candidate-verification gather. True matches are candidates
# too, so this must comfortably exceed the expected match count per shard.
DEFAULT_VERIFY_CAPACITY = 131072


def rk_window_hashes(text: jnp.ndarray, powers: jnp.ndarray) -> jnp.ndarray:
    """uint32[N] of window hashes H[i] = sum_j text[i+j]*powers[j] mod 2**32.

    Short patterns unroll into one fused MAC chain; long patterns roll up
    into a fori_loop so trace size stays O(1) in m (round-1 verdict,
    weak #6: the unrolled chain at m=256 over a full-corpus array made
    compile time blow up).
    """
    from .naive import UNROLL_LIMIT

    n_pos = text.shape[0]
    m = powers.shape[0]
    padded = jnp.pad(text, (0, m)).astype(jnp.uint32)
    if m <= UNROLL_LIMIT:
        h = padded[0:n_pos] * powers[0]
        for j in range(1, m):
            h = h + padded[j : j + n_pos] * powers[j]
        return h

    def body(j, h):
        win = jax.lax.dynamic_slice(padded, (j,), (n_pos,))
        return h + win * powers[j]

    return jax.lax.fori_loop(
        0, m, body, vma.taint(jnp.zeros((n_pos,), jnp.uint32), padded)
    )


def _verify_candidates(
    text: jnp.ndarray,
    pattern: jnp.ndarray,
    cand: jnp.ndarray,
    verify_capacity: int,
) -> jnp.ndarray:
    """Exactly verify a candidate mask.

    Fast path: gather up to ``verify_capacity`` candidate windows and compare.
    Slow path (cand count exceeds capacity): full naive verify.  Both paths
    return the exact start mask restricted to candidates.
    """
    n_pos = text.shape[0]
    m = pattern.shape[0]
    # There can be at most n_pos candidates: clamp the gather to the text
    # size, so a short text never gathers verify_capacity windows.
    verify_capacity = min(verify_capacity, n_pos)
    n_cand = jnp.sum(cand, dtype=jnp.int32)

    def fast_at(cap: int):
        # Count-tiered: rank-select AND window gather both cost per row,
        # so the gather runs at the smallest tier that holds the candidate
        # count, not at the configured capacity.  The output mask shape is
        # cap-independent, so the switch needs no padding.
        padded = jnp.pad(text, (0, m))
        idx = masked_positions(cand, cap, fill=n_pos)
        windows = padded[idx[:, None] + jnp.arange(m)[None, :]]
        ok = jnp.all(windows == pattern[None, :], axis=1) & (idx < n_pos)
        out = jnp.zeros((n_pos,), jnp.bool_)
        return out.at[idx].max(ok, mode="drop")

    def fast(_):
        return tiered_by_count(fast_at, n_cand, verify_capacity)

    def slow(_):
        return cand & naive_start_mask(text, pattern)

    return jax.lax.cond(n_cand <= verify_capacity, fast, slow, operand=None)


def rk_start_mask(
    text: jnp.ndarray,
    pattern: jnp.ndarray,
    powers: jnp.ndarray,
    pattern_hash: jnp.ndarray,
    verify_capacity: int = DEFAULT_VERIFY_CAPACITY,
) -> jnp.ndarray:
    """Exact start mask via hash screen + verification (single pattern)."""
    h = rk_window_hashes(text, powers)
    cand = h == pattern_hash
    return _verify_candidates(text, pattern, cand, verify_capacity)


def rk_multi_start_masks(
    text: jnp.ndarray,
    patterns: jnp.ndarray,
    powers: jnp.ndarray,
    pattern_hashes: jnp.ndarray,
    verify_capacity: int = DEFAULT_VERIFY_CAPACITY,
) -> jnp.ndarray:
    """Exact start masks for k equal-length patterns, bool[k, N].

    The window hash is computed once; each pattern adds only a scalar compare
    plus candidate verification.  ``patterns`` is uint8[k, m];
    ``pattern_hashes`` is uint32[k].
    """
    h = rk_window_hashes(text, powers)
    k = patterns.shape[0]
    masks = []
    for p in range(k):
        cand = h == pattern_hashes[p]
        masks.append(_verify_candidates(text, patterns[p], cand, verify_capacity))
    return jnp.stack(masks, axis=0)
