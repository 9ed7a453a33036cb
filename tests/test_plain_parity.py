"""Plain-path parity: all four algorithms against the oracle over pattern
lengths 1..256 and English, DNA and UTF-8 text (the path XLA compiles for
the GPU and the CPU)."""

import numpy as np
import pytest

from conformance.oracle import find_all
from parallel_implementation_of_string_matching_algorithms_opencl_tpu import (
    match,
)
from parallel_implementation_of_string_matching_algorithms_opencl_tpu.utils.config import (
    MatchConfig,
)
from parallel_implementation_of_string_matching_algorithms_opencl_tpu.utils.io import (
    GENERATORS,
)

CFG = MatchConfig(capacity=4096, verify_capacity=4096, pad_multiple=1024)
N = 3000


def _case(corpus: str, m: int) -> tuple[bytes, bytes]:
    seed = m * 31 + len(corpus)
    if corpus == "utf8":
        text = GENERATORS["utf8"](N, seed=seed)[:N].ljust(N, b" ")
    else:
        text = GENERATORS[corpus](N, seed=seed)
    text = bytearray(text)
    rng = np.random.default_rng(seed)
    p0 = int(rng.integers(0, N - m))
    pat = bytes(text[p0:p0 + m])
    for p in (0, N - m, N // 2 - m // 2):  # text ends and the middle
        text[p:p + m] = pat
    return bytes(text), pat


@pytest.mark.parametrize("corpus", ["english", "dna", "utf8"])
@pytest.mark.parametrize("m", [1, 2, 3, 4, 16, 64, 256])
@pytest.mark.parametrize("algo", ["naive", "rabin_karp", "kmp",
                                  "boyer_moore"])
def test_plain_path_matches_oracle(algo, m, corpus):
    text, pat = _case(corpus, m)
    want = find_all(text, pat)
    r = match(text, pat, algo=algo, config=CFG)
    assert r.count == len(want) and not r.overflow
    assert r.offsets_list() == want


@pytest.mark.parametrize("chunk,m", [(8, 40), (64, 65), (1, 2), (64, 64)])
def test_kmp_chunks_shorter_than_the_halo(chunk, m):
    # A lane's halo comes from the next lane only, so a chunk shorter than
    # m - 1 bytes scans the text in one lane.
    text, pat = _case("english", m)
    r = match(text, pat, algo="kmp", config=CFG.replace(kmp_chunk=chunk))
    assert r.offsets_list() == find_all(text, pat)


@pytest.mark.parametrize("pad_multiple", [1, 3, 7])
@pytest.mark.parametrize("algo", ["naive", "rabin_karp", "kmp",
                                  "boyer_moore"])
def test_any_positive_pad_multiple(algo, pad_multiple):
    text, pat = _case("dna", 16)
    r = match(text, pat, algo=algo,
              config=CFG.replace(pad_multiple=pad_multiple))
    assert r.offsets_list() == find_all(text, pat)
