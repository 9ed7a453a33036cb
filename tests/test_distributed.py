"""Distributed (shard_map) parity tests on the forced-8-device CPU mesh
(SURVEY.md §4.5): halo correctness at shard seams, psum/all_gather merge."""

import os
import sys

import jax
import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from conformance.oracle import find_all

from parallel_implementation_of_string_matching_algorithms_opencl_tpu import (
    MatchConfig,
    match_distributed,
)
from parallel_implementation_of_string_matching_algorithms_opencl_tpu.parallel import (
    make_data_mesh,
)

pytestmark = pytest.mark.slow  # compile-heavy; fast suite runs -m 'not slow'

ALGOS = ["naive", "rabin_karp", "kmp", "boyer_moore"]
CFG = MatchConfig(capacity=1024, verify_capacity=1024, kmp_chunk=64, bm_chunk=64,
                  pad_multiple=64)


def test_eight_devices_available():
    assert len(jax.devices()) == 8


@pytest.mark.parametrize("algo", ALGOS)
def test_dist_parity_random(algo):
    rng = np.random.default_rng(42)
    alpha = np.frombuffer(b"ab", dtype=np.uint8)
    text = rng.choice(alpha, size=3000).tobytes()
    pattern = b"abba"
    res = match_distributed(text, pattern, algo=algo, config=CFG)
    assert res.count == len(find_all(text, pattern))
    assert res.offsets_list() == find_all(text, pattern)


@pytest.mark.parametrize("algo", ALGOS)
def test_dist_shard_seam_matches(algo):
    # 8 shards; text padded to multiple of 64*8=512 -> shard size depends on
    # padded length.  Plant matches straddling every shard boundary.
    mesh = make_data_mesh()
    d = len(jax.devices())
    n = 4096  # padded shard size = 512 per device
    shard = n // d
    m = 6
    pattern = b"QWERTY"
    text = bytearray(b"." * n)
    planted = []
    for b in range(1, d):
        s = b * shard - 3  # straddles the seam
        text[s : s + m] = pattern
        planted.append(s)
    # also at the very start and very end
    text[0:m] = pattern
    text[n - m :] = pattern
    planted = [0] + planted + [n - m]
    text = bytes(text)
    want = find_all(text, pattern)
    assert want == sorted(planted)
    res = match_distributed(text, pattern, algo=algo, config=CFG, mesh=mesh)
    assert res.offsets_list() == want
    assert res.count == len(want)


def test_dist_unpadded_length_and_tail():
    # Text length not divisible by the shard count; match at the very tail.
    pattern = b"zz"
    text = b"a" * 1001 + b"zz"
    res = match_distributed(text, pattern, algo="naive", config=CFG)
    assert res.offsets_list() == [1001]


@pytest.mark.parametrize("algo", ALGOS)
def test_dist_long_pattern_multihop_halo(algo):
    # Round-1 VERDICT repro: pattern longer than one shard (m-1 > shard_len)
    # needs halo bytes from SEVERAL right neighbors.  8192-byte text over 8
    # shards (1024 each), m=1500 planted at 2000 spans shards 1..3.
    rng = np.random.default_rng(7)
    data = bytearray(rng.integers(ord("a"), ord("e"), size=8192,
                                  dtype=np.uint8).tobytes())
    pattern = bytes(rng.integers(ord("f"), ord("z"), size=1500,
                                 dtype=np.uint8).tobytes())
    data[2000 : 2000 + 1500] = pattern
    text = bytes(data)
    want = find_all(text, pattern)
    assert want == [2000]
    res = match_distributed(text, pattern, algo=algo, config=CFG)
    assert res.count == 1
    assert res.offsets_list() == [2000]


def test_dist_pattern_spanning_most_shards():
    # m nearly the whole text: halo must chain across ~all shards; also the
    # no-match case (pattern longer than any shard but absent).
    text = bytes(bytearray(range(256)) * 24)  # 6144 bytes, 768/shard
    pattern = text[100 : 100 + 5000]
    res = match_distributed(text, pattern, algo="naive", config=CFG)
    want = find_all(text, pattern)
    assert res.offsets_list() == want and res.count == len(want)
    absent = b"\xff" * 5000
    res2 = match_distributed(text, absent, algo="kmp", config=CFG)
    assert res2.count == 0 and res2.offsets_list() == []


def test_dist_multi_pattern_rk_shared_pass():
    # Multi-pattern through the mesh (config 2 at mesh scale): equal-length
    # patterns share ONE per-shard rolling-hash pass; mixed lengths group.
    rng = np.random.default_rng(11)
    data = bytearray(rng.integers(97, 105, size=6000, dtype=np.uint8).tobytes())
    p1, p2, p3 = b"ZAP!", b"WOW?", b"LONGER0"
    shard = 6016 // 8  # padded shard size (pad_multiple 64 * 8)
    for pos, p in [(0, p1), (shard - 2, p1), (3 * shard - 1, p2),
                   (2000, p2), (5 * shard - 3, p3), (5990, p1)]:
        data[pos : pos + len(p)] = p
    text = bytes(data)
    pats = [p1, p2, p3]
    results = match_distributed(text, pats, algo="rabin_karp", config=CFG)
    assert len(results) == 3
    for p, r in zip(pats, results):
        want = find_all(text, p)
        assert r.count == len(want), p
        assert r.offsets_list() == want, p
    assert results[0].algo.startswith("rabin_karp_multi@mesh")


def test_dist_multi_pattern_other_algo():
    text = b"abcabcabc" * 300
    pats = [b"abca", b"cab"]
    results = match_distributed(text, pats, algo="kmp", config=CFG.replace(capacity=4096))
    for p, r in zip(pats, results):
        want = find_all(text, p)
        assert r.count == len(want) and r.offsets_list() == want


def test_dist_overlapping_across_seams():
    # Periodic pattern overlapping across everything.
    text = b"a" * 2048
    res = match_distributed(text, b"aaaa", algo="kmp", config=CFG.replace(capacity=4096))
    want = find_all(text, b"aaaa")
    assert res.count == len(want)
    assert res.offsets_list() == want


@pytest.mark.parametrize("mode", ["count_sized", "fixed"])
def test_dist_gather_modes_parity(mode):
    # Round-4 two-phase count-sized gather vs the fixed-capacity gather:
    # identical results, including a zero-match text (bucket 0 -> the
    # gather dispatch is skipped entirely).
    cfg = CFG.replace(dist_gather=mode)
    rng = np.random.default_rng(7)
    text = rng.choice(
        np.frombuffer(b"abc", dtype=np.uint8), size=5000
    ).tobytes()
    pattern = b"abcabc"
    want = find_all(text, pattern)
    res = match_distributed(text, pattern, algo="naive", config=cfg)
    assert res.count == len(want) and res.offsets_list() == want
    # zero matches
    res0 = match_distributed(text, b"ZZZZ", algo="naive", config=cfg)
    assert res0.count == 0 and res0.offsets_list() == []


@pytest.mark.parametrize("mode", ["count_sized", "fixed"])
def test_dist_resolve_runner_output(mode):
    # Raw-runner consumers (bench harnesses) must go through
    # resolve_runner_output: the count_sized runner's out[1] is the pmax
    # scalar, NOT offsets — reading it raw returned one bogus offset with
    # an exact count (round-4 config-3 bench regression).  Exercise a
    # per-shard count > 128 so the bucket escalates past its floor.
    import jax.numpy as jnp

    from parallel_implementation_of_string_matching_algorithms_opencl_tpu.parallel.dist import (  # noqa: E501
        DistributedMatcher,
        _put_sharded,
    )

    cfg = CFG.replace(capacity=1024, dist_gather=mode)
    text = bytearray(b"." * 8192)
    text[0:400] = b"a" * 400  # 399 'aa' starts in shard 0 (> 128 bucket floor)
    text[5000:5020] = b"a" * 20
    want = find_all(bytes(text), b"aa")
    dm = DistributedMatcher(b"aa", algo="naive", config=cfg)
    mesh = dm.mesh
    td, _ = _put_sharded(np.frombuffer(bytes(text), np.uint8), mesh, cfg)
    runner = dm._build(mesh, type(dm.matcher), dm.config, dm.m)
    out = runner(td, jnp.int32(len(text)),
                 jnp.asarray(dm.matcher.pattern_arr),
                 jax.tree.map(jnp.asarray, dm.matcher.tables))
    count, _ovf, _scounts, rows = dm.resolve_runner_output(out)
    offs = rows.reshape(-1)
    got = sorted(int(x) for x in offs[offs >= 0])
    assert count == len(want) and got == want


def test_dist_count_sized_bucket_overflow_shard():
    # One shard holds more matches than the 128-floor bucket: pmax must
    # size the gather up so no offset is lost.
    cfg = CFG.replace(dist_gather="count_sized")
    text = bytearray(b"." * 4096)
    text[0:600] = b"a" * 600  # 599 'aa' matches, all in shard 0
    want = find_all(bytes(text), b"aa")
    res = match_distributed(bytes(text), b"aa", algo="naive", config=cfg)
    assert res.count == len(want) == 599
    assert res.offsets_list() == want


@pytest.mark.parametrize("mode", ["count_sized", "fixed"])
def test_dist_drain_recovers_all_offsets(mode):
    # Round-3 VERDICT missing #3: per-shard capacity overflow on the mesh
    # must still return EVERY offset with drain=True. capacity 16 << 599
    # matches packed into shard 0 (and some in shard 5).
    cfg = CFG.replace(capacity=16, dist_gather=mode)
    text = bytearray(b"." * 4096)
    text[0:600] = b"a" * 600          # 599 'aa' matches in shard 0
    text[2560:2600] = b"a" * 40       # 39 more inside shard 5
    want = find_all(bytes(text), b"aa")
    res = match_distributed(bytes(text), b"aa", algo="naive", config=cfg,
                            drain=True)
    assert res.count == len(want) == 638
    assert not res.overflow
    assert res.offsets_list() == want


def test_dist_multi_drain_recovers_all_offsets():
    # Multi-pattern mesh drain: one pattern overflows per-shard capacity,
    # the other doesn't; both must come back complete.
    cfg = CFG.replace(capacity=16)
    text = bytearray(b"." * 4096)
    text[0:200] = b"ab" * 100         # 100 'ab' in shard 0 (> cap 16)
    text[3000:3008] = b"cd" * 4       # 4 'cd' in shard 5/6
    pats = [b"ab", b"cd"]
    wants = [find_all(bytes(text), p) for p in pats]
    rs = match_distributed(bytes(text), pats, algo="rabin_karp",
                           config=cfg, drain=True)
    for r, want in zip(rs, wants):
        assert r.count == len(want)
        assert not r.overflow
        assert r.offsets_list() == want


@pytest.mark.parametrize("algo", ["kmp", "rabin_karp"])
def test_dist_single_device_mesh_parity(algo):
    # D == 1 mesh: the halo concat is skipped (no neighbors) — exactness
    # must hold on the exact same path the config-3 bench rows time.
    mesh = make_data_mesh(1)
    rng = np.random.default_rng(51)
    data = bytearray(rng.integers(97, 123, size=20000, dtype=np.uint8).tobytes())
    pat = b"XYZZYX"
    for p in (0, 7777, 20000 - len(pat)):
        data[p : p + len(pat)] = pat
    text = bytes(data)
    want = find_all(text, pat)
    res = match_distributed(text, pat, algo=algo, config=CFG, mesh=mesh)
    assert res.count == len(want)
    assert res.offsets_list() == want


def test_dist_multi_single_device_mesh_parity():
    from parallel_implementation_of_string_matching_algorithms_opencl_tpu.parallel.dist import (
        DistributedMultiMatcher,
    )

    mesh = make_data_mesh(1)
    rng = np.random.default_rng(52)
    data = bytearray(rng.integers(97, 123, size=20000, dtype=np.uint8).tobytes())
    pats = [b"XYZZYX", b"QQWWEE"]
    for p in (100, 9999, 20000 - 6):
        data[p : p + 6] = pats[0]
    data[5000:5006] = pats[1]
    text = bytes(data)
    dm = DistributedMultiMatcher(pats, config=CFG, mesh=mesh)
    for p, r in zip(pats, dm.match(text)):
        want = find_all(text, p)
        assert r.count == len(want) and r.offsets_list() == want, p
