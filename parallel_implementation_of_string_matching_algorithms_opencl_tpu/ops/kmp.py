"""KMP (branchless dense-DFA automaton scan) matcher op — jnp compute path.

JAX redesign of the reference's KMP OpenCL kernel (SURVEY.md component
R3, BASELINE.json:5 "branchless automaton step for KMP").  Design:

- The failure function is densified on the host into a ``(m+1, 256)`` DFA
  (ops/tables.kmp_dfa); the device step is the branchless gather
  ``state = dfa[state, byte]`` with zero data-dependent control flow.
- Lane-parallel decomposition (SURVEY.md hard part #4): the text is split
  into L chunks of C bytes; lane l scans bytes [l*C, l*C + C + m - 1) from
  state 0 and reports matches *starting* in its owned [l*C, (l+1)*C).
  No pre-halo is needed: a KMP match starting at position s is fully
  determined by bytes [s, s+m), so a lane that begins scanning at its owned
  start detects every owned match (state-anchored analysis in SURVEY.md §7.4
  item 6).  The (m-1)-byte tail overlap is the only duplication.
- The per-step DFA gather is the honest cost of KMP on a vector machine:
  throughput is gather-bound and the sequential dependence is per-lane.
  More lanes (smaller C) trade halo duplication for parallelism.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from . import vma

DEFAULT_CHUNK = 2048


def kmp_start_mask(
    text: jnp.ndarray,
    dfa: jnp.ndarray,
    chunk: int = DEFAULT_CHUNK,
) -> jnp.ndarray:
    """Exact start mask via lane-parallel DFA scan.

    ``text`` uint8[N]; ``dfa`` int32[(m+1), 256].  Returns bool[N].
    """
    n_pos = text.shape[0]
    m = dfa.shape[0] - 1
    if m > n_pos:
        return jnp.zeros((n_pos,), jnp.bool_)
    c = min(chunk, n_pos)
    if m - 1 > c:
        # A lane's (m-1)-byte tail halo comes from the next chunk only, so
        # chunks must be at least m-1 long; otherwise scan in a single lane.
        c = n_pos
    lanes = -(-n_pos // c)  # cdiv
    total = lanes * c
    # Lane l reads bytes [l*c, l*c + c + m - 1); build the overlapped (L, c+m-1)
    # view from two aligned reshapes (no gather).
    padded = jnp.pad(text, (0, total + c - n_pos))
    base = padded[:total].reshape(lanes, c)
    tail = padded[c : c + total].reshape(lanes, c)[:, : m - 1]
    ext = jnp.concatenate([base, tail], axis=1)  # (L, c+m-1)

    dfa_flat = dfa.reshape(-1)

    def step(state, byte_col):
        nxt = dfa_flat[state * 256 + byte_col.astype(jnp.int32)]
        return nxt, nxt == m

    _, hits = jax.lax.scan(
        step, vma.taint(jnp.zeros((lanes,), jnp.int32), ext), ext.T
    )  # hits: (c+m-1, L); hit at step t == match ENDING at lane-local t
    # A match ending at t starts at t-m+1; owned starts are lane-local [0, c).
    start_hits = hits.T[:, m - 1 :]  # (L, c)
    return start_hits.reshape(total)[:n_pos]
