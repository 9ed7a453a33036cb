"""Seeded property/fuzz tests (SURVEY.md §4.2).

Random corpora over four alphabets x pattern lengths 4..256, patterns
planted at adversarial positions (tile/shard/chunk seams, offset 0, n-m),
absent patterns, pattern == text, periodic patterns.  Every case asserts
exact count+offset parity against the oracle, across all four algorithms,
on the plain jax.numpy path.
"""

import numpy as np
import pytest

from conformance.oracle import find_all
from parallel_implementation_of_string_matching_algorithms_opencl_tpu import match
from parallel_implementation_of_string_matching_algorithms_opencl_tpu.utils.config import (
    MatchConfig,
)
from parallel_implementation_of_string_matching_algorithms_opencl_tpu.utils.io import (
    GENERATORS,
)

pytestmark = pytest.mark.slow  # fuzz sweeps; fast suite runs -m 'not slow'

ALGOS = ["naive", "rabin_karp", "kmp", "boyer_moore"]

JNP_CFG = MatchConfig(capacity=1 << 17, verify_capacity=1 << 17)
def _case(alphabet: str, m: int, seed: int, n: int = 70_000):
    rng = np.random.default_rng(seed)
    if alphabet == "utf8":
        text = bytearray(GENERATORS["utf8"](n // 2, seed=seed)[:n].ljust(n, b" "))
    else:
        text = bytearray(GENERATORS[alphabet](n, seed=seed))
    # pattern drawn from the text itself (guaranteed >= 1 occurrence) …
    p0 = int(rng.integers(0, n - m))
    pat = bytes(text[p0 : p0 + m])
    # … and planted at adversarial seams
    for p in [0, n - m, 512 - 1, 512, 8192 - m // 2, n // 2]:
        if 0 <= p <= n - m and rng.random() < 0.8:
            text[p : p + m] = pat
    return bytes(text), pat


@pytest.mark.parametrize("alphabet", ["binary", "dna", "english", "utf8"])
@pytest.mark.parametrize("m", [4, 16, 31, 256])
@pytest.mark.parametrize("algo", ALGOS)
def test_fuzz_jnp(alphabet, m, algo, subtests=None):
    text, pat = _case(alphabet, m, seed=hash((alphabet, m)) % 10_000)
    expected = find_all(text, pat)
    assert expected, "case must have at least one occurrence"
    r = match(text, pat, algo=algo, config=JNP_CFG)
    assert r.count == len(expected)
    assert r.offsets_list() == expected


@pytest.mark.parametrize("algo", ALGOS)
def test_pattern_equals_text(algo):
    text = GENERATORS["english"](4096, seed=1)
    r = match(text, text, algo=algo, config=JNP_CFG)
    assert r.count == 1 and r.offsets_list() == [0]


@pytest.mark.parametrize("algo", ALGOS)
def test_absent_pattern(algo):
    text = GENERATORS["dna"](50_000, seed=2)
    r = match(text, b"XYZW" * 4, algo=algo, config=JNP_CFG)
    assert r.count == 0 and r.offsets_list() == []


@pytest.mark.parametrize("algo", ALGOS)
@pytest.mark.parametrize("period", [1, 2, 3])
def test_periodic_patterns(algo, period):
    # Highly periodic pattern over periodic text: maximal overlap density.
    unit = bytes(range(65, 65 + period))
    text = unit * 5000
    pat = unit * (8 // period + 1)
    expected = find_all(text, pat)
    cfg = JNP_CFG.replace(capacity=len(text))
    r = match(text, pat, algo=algo, config=cfg)
    assert r.count == len(expected)
    assert r.offsets_list() == expected


@pytest.mark.parametrize("algo", ALGOS)
def test_m_equals_one_and_n(algo):
    text = GENERATORS["binary"](9999, seed=3)
    b = text[777:778]
    expected = find_all(text, b)
    cfg = JNP_CFG.replace(capacity=16384)
    r = match(text, b, algo=algo, config=cfg)
    assert r.count == len(expected)
    assert r.offsets_list() == expected


def test_multibyte_utf8_offsets():
    # Offsets are byte offsets into the UTF-8 encoding, not char indices.
    s = "héllo wörld 😀 héllo 中文 héllo"
    pat = "héllo"
    expected = find_all(s.encode(), pat.encode())
    for algo in ALGOS:
        r = match(s, pat, algo=algo, config=JNP_CFG)
        assert r.offsets_list() == expected, algo


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_stream_drain_fuzz(seed, tmp_path):
    # Round-5 streaming drain under randomized density: random corpus with
    # random dense runs, random tiny capacity, random chunk size — every
    # oracle offset must come back with overflow=False, across chunk-seam
    # splits the fuzzer has no knowledge of.
    from parallel_implementation_of_string_matching_algorithms_opencl_tpu.parallel.streaming import (
        match_stream,
    )

    rng = np.random.default_rng(100 + seed)
    n = int(rng.integers(40_000, 120_000))
    alpha = ["binary", "dna", "english"][seed % 3]
    data = bytearray(GENERATORS[alpha](n, seed=200 + seed))
    m = int(rng.integers(2, 9))
    pat = bytes(rng.integers(97, 100, size=m, dtype=np.uint8))
    # dense runs of the pattern at random spots (heavy overlap for m>1)
    for _ in range(int(rng.integers(1, 4))):
        pos = int(rng.integers(0, n - 40 * m))
        run = (pat * 40)[: 40 * m]
        data[pos : pos + len(run)] = run
    text = bytes(data)
    want = find_all(text, pat)
    path = tmp_path / f"fuzz{seed}.bin"
    path.write_bytes(text)
    cap = int(rng.integers(4, 40))
    chunk = int(rng.integers(2, 6)) * 4096
    cfg = MatchConfig(capacity=cap, verify_capacity=max(cap, 64),
                      pad_multiple=1024)
    algo = ALGOS[int(rng.integers(0, 4))]
    r = match_stream(str(path), pat, algo=algo, config=cfg,
                     chunk_bytes=chunk, drain=True)
    assert r.count == len(want), (algo, cap, chunk)
    assert r.offsets_list() == want, (algo, cap, chunk)
    assert not r.overflow
