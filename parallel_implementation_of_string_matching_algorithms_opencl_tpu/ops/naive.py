"""Naive (shift-AND window compare) matcher op — jnp compute path.

JAX redesign of the reference's naive OpenCL kernel (SURVEY.md
component R1): instead of one work-item per position doing a byte loop, we
compute, for each pattern index j, the vectorized compare
``text[j : j+N] == pattern[j]`` and AND the m shifted masks together.  XLA
fuses the whole chain into one pass over the text; there is no
data-dependent control flow and no gather.

This op is also the exact-verification workhorse for the other algorithms'
candidate masks, and the semantic ground truth for the other algorithms.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from . import vma

# Above this pattern length the shifted-compare chain rolls up into a
# fori_loop: an unrolled chain is one fused vector pass but O(m) HLO ops over
# the FULL array, and at m=256 trace size / compile time blow up
# (round-1 verdict, weak #6).  The rolled form is O(1) trace size; it costs
# m separate passes, acceptable on the fallback/tail paths that use this op
# for long patterns.
UNROLL_LIMIT = 64


def naive_start_mask(text: jnp.ndarray, pattern: jnp.ndarray) -> jnp.ndarray:
    """Boolean mask over positions: mask[i] == (text[i:i+m] == pattern).

    ``text`` is uint8[N]; ``pattern`` is uint8[m] (m static via shape).  The
    mask is computed for every i in [0, N); positions whose window crosses the
    end of the *valid* region must be cleared by the caller via
    ``emit.valid_start_mask`` (the pad bytes are zeros, so a pattern of zeros
    could otherwise false-positive in the tail).
    """
    n_pos = text.shape[0]
    m = pattern.shape[0]
    padded = jnp.pad(text, (0, m))
    if m <= UNROLL_LIMIT:
        mask = padded[0:n_pos] == pattern[0]
        for j in range(1, m):
            mask &= padded[j : j + n_pos] == pattern[j]
        return mask

    def body(j, mask):
        win = jax.lax.dynamic_slice(padded, (j,), (n_pos,))
        return mask & (win == pattern[j])

    return jax.lax.fori_loop(
        0, m, body, vma.taint(jnp.ones((n_pos,), jnp.bool_), padded)
    )
