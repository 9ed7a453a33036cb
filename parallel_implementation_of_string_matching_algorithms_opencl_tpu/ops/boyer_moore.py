"""Boyer-Moore matcher op — jnp compute path, two execution strategies.

JAX redesign of the reference's Boyer-Moore OpenCL kernel (SURVEY.md
component R4, BASELINE.json:5 "skip-loop for BM").  Both strategies use the
classic bad-character + good-suffix tables (ops/tables) and produce the same
exact start mask; they differ in how BM's *data-dependent skipping* is mapped
onto a vector machine (SURVEY.md §7.4 hard part #5):

- ``filtered`` (default, fast): BM's last-character heuristic vectorized.
  A cheap probe screen (last, first, middle pattern bytes — 3 vector passes
  instead of m) produces a candidate mask; candidates are exactly verified
  via a fixed-capacity window gather.  This is the vector translation of
  the skip loop: instead of one cursor skipping bytes, positions the screen
  rejects never reach the expensive verify.

- ``cursor`` (honest skip-loop): L lane cursors, each owning a C-byte chunk,
  advance under a ``lax.while_loop`` by ``max(bad_char, good_suffix)`` shifts
  exactly as the sequential algorithm does.  Lanes step in lockstep (SIMD
  masking), so wall-clock is set by the slowest lane; gathers dominate.
  Kept as the faithful algorithmic variant and for parity testing.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from . import vma

from .rabin_karp import DEFAULT_VERIFY_CAPACITY, _verify_candidates

DEFAULT_CURSOR_CHUNK = 4096


def bm_probe_positions(m: int) -> list[int]:
    """Screen probe positions: last byte (BM's driving heuristic), first byte,
    middle byte — deduplicated, order preserved."""
    probes = [m - 1, 0, m // 2]
    seen: set[int] = set()
    out = []
    for p in probes:
        if p not in seen:
            seen.add(p)
            out.append(p)
    return out


def bm_start_mask_filtered(
    text: jnp.ndarray,
    pattern: jnp.ndarray,
    verify_capacity: int = DEFAULT_VERIFY_CAPACITY,
) -> jnp.ndarray:
    """Exact start mask via vectorized probe screen + exact verification."""
    n_pos = text.shape[0]
    m = pattern.shape[0]
    padded = jnp.pad(text, (0, m))
    cand = None
    for j in bm_probe_positions(m):
        eq = padded[j : j + n_pos] == pattern[j]
        cand = eq if cand is None else (cand & eq)
    return _verify_candidates(text, pattern, cand, verify_capacity)


def bm_start_mask_cursor(
    text: jnp.ndarray,
    pattern: jnp.ndarray,
    bad_char: jnp.ndarray,
    good_suffix: jnp.ndarray,
    chunk: int = DEFAULT_CURSOR_CHUNK,
) -> jnp.ndarray:
    """Exact start mask via lane-parallel masked skip loop.

    ``bad_char`` int32[256] (last occurrence, -1 if absent); ``good_suffix``
    int32[m+1] with good_suffix[j+1] = shift on mismatch at pattern index j,
    good_suffix[0] = shift after a full match (ops/tables.bm_good_suffix).
    """
    n_pos = text.shape[0]
    m = pattern.shape[0]
    c = min(chunk, n_pos)
    lanes = -(-n_pos // c)
    total = lanes * c
    padded = jnp.pad(text, (0, total + m - n_pos))  # window reads < total + m
    starts = jnp.arange(lanes, dtype=jnp.int32) * c
    ends = starts + c
    offs = jnp.arange(m, dtype=jnp.int32)[None, :]

    def cond(carry):
        cursor, _ = carry
        return jnp.any(cursor < ends)

    def body(carry):
        cursor, mask = carry
        active = cursor < ends
        cur = jnp.minimum(cursor, total - 1)
        window = padded[cur[:, None] + offs]  # (L, m) gather
        eq = window == pattern[None, :]
        full = jnp.all(eq, axis=1)
        neq = ~eq
        # Rightmost mismatch index (valid only when not full).
        j_mis = (m - 1) - jnp.argmax(neq[:, ::-1], axis=1)
        mis_byte = jnp.take_along_axis(window, j_mis[:, None], axis=1)[:, 0]
        bc_shift = j_mis - bad_char[mis_byte.astype(jnp.int32)]
        gs_shift = good_suffix[j_mis + 1]
        shift_mismatch = jnp.maximum(1, jnp.maximum(bc_shift, gs_shift))
        shift = jnp.where(full, good_suffix[0], shift_mismatch)
        hit = full & active
        mask = mask.at[cur].max(hit, mode="drop")
        cursor = jnp.where(active, cursor + shift, cursor)
        return cursor, mask

    _, mask = jax.lax.while_loop(
        cond, body, vma.taint((starts, jnp.zeros((total,), jnp.bool_)), text)
    )
    return mask[:n_pos]
