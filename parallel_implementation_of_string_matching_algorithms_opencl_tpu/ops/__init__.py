"""Compute ops: table precompute, start masks, offset emission.

The ``jax.numpy`` implementations in this package are the semantic ground
truth and the one execution path: XLA compiles them for the GPU and the CPU.
"""

from . import boyer_moore, emit, kmp, naive, rabin_karp, tables  # noqa: F401
