"""Fixed-capacity match-offset emission (SURVEY.md §7.3 stage 2, hard part #1).

XLA has no dynamic shapes, so "return the list of match offsets" becomes
"return a fixed-capacity int32 buffer + a count + an overflow flag".  This is
the JAX equivalent of the reference's per-work-item result buffer readback
(SURVEY.md component R12): one-pass padded emission.

All algorithm ops produce a boolean *start mask* over text positions
(mask[i] == True iff a match starts at byte i); this module turns masks into
(count, offsets, overflow) triples under jit.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

# Default per-call offset capacity.  Callers can raise it; counts are always
# exact even when the offset buffer overflows.
DEFAULT_CAPACITY = 65536

FILL = -1  # padding value in offset buffers


def mask_to_matches(mask: jnp.ndarray, capacity: int):
    """Convert a boolean start-position mask into fixed-capacity results.

    Returns (count:int32 scalar, offsets:int32[capacity] sorted with -1 pad,
    overflow:bool scalar).

    Extraction is a rank-select (``_rank_select_bool``) whose cost scales
    with the offset capacity, not ``jnp.nonzero(size=)``, which sorts all
    N positions.  Output order is ascending by construction.
    """
    n = mask.shape[0]
    count = jnp.sum(mask, dtype=jnp.int32)
    offsets = _adaptive(
        lambda cap: _rank_select_bool(mask, count, cap), count, capacity
    )
    return count, offsets, count > capacity


# Extraction cost scales with the rank count extracted (the per-rank row
# gather dominates); most runs have far fewer matches
# than the offset capacity, so run the extraction at the smallest rank tier
# that fits the runtime count.  The x4 ladder bounds the waste at 4x the
# count while keeping the lax.switch branch count (= trace size) small.
_SMALL_CAP = 4096


def tiered_by_count(fn, count, capacity: int, floor: int = _SMALL_CAP):
    """Run ``fn(cap)`` at the smallest x4-ladder tier >= the runtime
    ``count`` (lax.switch).  ``fn`` must return identically-shaped pytrees
    for every cap — use this directly when the output shape is
    cap-independent (e.g. a full-length mask); use ``_adaptive`` for
    cap-shaped offset buffers (it pads them to ``capacity``)."""
    if capacity <= floor:
        return fn(capacity)
    tiers = []
    t = floor
    while t < capacity:
        tiers.append(t)
        t *= 4
    tiers.append(capacity)
    bucket = sum(
        (count > jnp.int32(t)).astype(jnp.int32) for t in tiers[:-1]
    )
    return jax.lax.switch(bucket, [lambda t=t: fn(t) for t in tiers])


def _adaptive(extract, count, capacity: int):
    def at(t: int):
        out = extract(t)
        if t == capacity:
            return out
        return jnp.concatenate([out, jnp.full((capacity - t,), FILL, out.dtype)])

    return tiered_by_count(at, count, capacity)


_BLOCK = 128  # bool-mask extraction block (one vector row)


def _rank_to_block(bpre, bsum, nb: int, capacity: int):
    """int32[capacity]: block id owning each rank, clamped in [0, nb-1].
    Entries past the total count are ARBITRARY valid block ids (the two
    lowerings disagree there: last nonempty block vs clamp to nb-1) —
    callers MUST mask on ``r < count``.

    Two lowerings, chosen statically: `searchsorted` binary-searches per
    rank; the inverse map scatters each nonempty block's id at its first
    rank and cummax-fills, which costs per block and wins whenever ranks
    aren't vastly outnumbered by blocks.
    """
    if nb <= 64 * capacity:
        starts = bpre - bsum  # exclusive prefix = block's first rank
        tgt = jnp.where(
            (bsum > 0) & (starts < capacity), starts, jnp.int32(capacity)
        )
        bi = (
            jnp.zeros((capacity,), jnp.int32)
            .at[tgt]
            .max(jnp.arange(nb, dtype=jnp.int32), mode="drop")
        )
        return jax.lax.cummax(bi)
    r = jnp.arange(capacity, dtype=jnp.int32)
    bi = jnp.searchsorted(bpre, r + 1, side="left").astype(jnp.int32)
    return jnp.minimum(bi, nb - 1)


def _rank_select_bool(mask: jnp.ndarray, count, capacity: int):
    """offsets[r] = position of the r-th set bit (ascending, -1 padded).

    Rank-select by block prefix + rank->block map + per-rank row gather:
    cost scales with ``capacity`` and one cheap reduction pass, instead of
    a scatter with one update per text position or a sort of all of them.
    """
    n = mask.shape[0]
    B = _BLOCK
    nb = -(-n // B)
    if n % B:
        mask = jnp.pad(mask, (0, nb * B - n))
    blk = mask.reshape(nb, B)
    bsum = jnp.sum(blk, axis=1, dtype=jnp.int32)
    bpre = jnp.cumsum(bsum, dtype=jnp.int32)  # inclusive
    r = jnp.arange(capacity, dtype=jnp.int32)
    bi_c = _rank_to_block(bpre, bsum, nb, capacity)
    prev = bpre[bi_c] - bsum[bi_c]
    rows = blk[bi_c].astype(jnp.int32)          # (capacity, B)
    wcum = jnp.cumsum(rows, axis=1)
    r_in = (r - prev)[:, None]
    wi = jnp.sum((wcum <= r_in).astype(jnp.int32), axis=1)
    pos = bi_c * B + wi
    return jnp.where(r < count, pos, FILL)


def masked_positions(mask: jnp.ndarray, capacity: int, fill: int = FILL):
    """First ``capacity`` positions where mask is True, ascending, padded
    with ``fill`` — same rank-select extraction as mask_to_matches."""
    count = jnp.sum(mask, dtype=jnp.int32)
    out = _rank_select_bool(mask, count, capacity)
    return jnp.where(out >= 0, out, fill)


def valid_start_mask(mask: jnp.ndarray, n: jnp.ndarray, m: int) -> jnp.ndarray:
    """Zero out mask entries at positions that cannot start a match because
    they fall beyond ``n - m`` (padding / halo tail).  ``n`` may be traced."""
    pos = jnp.arange(mask.shape[0], dtype=jnp.int32)
    return mask & (pos <= n - m)
