"""Real multi-process multi-host tests (SURVEY.md §3.3, BASELINE config 5).

Spawns N local processes that each run ``jax.distributed.initialize``
against a localhost coordinator on the CPU backend, then execute the
collective ``match_multihost`` — the same code path several hosts run,
with the cross-host collectives riding localhost gRPC here.  Matches are planted
straddling the host-slice boundary so the overlapping-file-read halo is
exercised for real.
"""

import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO_ROOT)
from conformance.oracle import find_all

WORKER = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                      "_multihost_worker.py")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _run_cluster(tmp_path, text: bytes, pattern: bytes, algo: str,
                 nprocs: int = 2, timeout: int = 240,
                 extra_args: tuple = ()):
    # _free_port has an inherent close-then-rebind window; retry on the
    # rare collision instead of failing the test spuriously.
    last = None
    for _ in range(3):
        try:
            return _run_cluster_once(tmp_path, text, pattern, algo,
                                     nprocs, timeout, extra_args)
        except AssertionError as e:
            last = e
            if "in use" not in str(e) and "Address already" not in str(e):
                raise
    raise last


def _run_cluster_once(tmp_path, text: bytes, pattern: bytes, algo: str,
                      nprocs: int = 2, timeout: int = 240,
                      extra_args: tuple = ()):
    corpus = tmp_path / "corpus.bin"
    corpus.write_bytes(text)
    port = _free_port()
    outs = [tmp_path / f"out_{pid}.json" for pid in range(nprocs)]
    env = dict(os.environ)
    # Workers need the repo root importable; keep whatever the parent
    # already had (site dirs etc.) rather than hardcoding machine paths.
    env["PYTHONPATH"] = os.pathsep.join(
        [REPO_ROOT] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                       if p and p != REPO_ROOT]
    )
    procs = [
        subprocess.Popen(
            [sys.executable, WORKER, str(pid), str(nprocs), str(port),
             str(corpus), pattern.hex() if isinstance(pattern, bytes)
             else ";".join(p.hex() for p in pattern),
             algo, str(outs[pid]), *map(str, extra_args)],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        )
        for pid in range(nprocs)
    ]
    results = []
    for p in procs:
        out, err = p.communicate(timeout=timeout)
        assert p.returncode == 0, (
            f"worker failed rc={p.returncode}\nstdout:{out.decode()[-2000:]}"
            f"\nstderr:{err.decode()[-2000:]}"
        )
    for o in outs:
        with open(o) as f:
            results.append(json.load(f))
    return results


@pytest.mark.slow
@pytest.mark.parametrize("algo", ["naive", "kmp"])
def test_two_process_multihost_parity(tmp_path, algo):
    rng = np.random.default_rng(13)
    data = bytearray(rng.integers(97, 101, size=20000, dtype=np.uint8).tobytes())
    pat = b"XSEAMX"
    # Host 0 owns [0, 10000): plant matches inside each slice, straddling
    # the host boundary, at file start and at file end.
    for p in (0, 4321, 10000 - 3, 10006, 17000, 20000 - len(pat)):
        data[p : p + len(pat)] = pat
    text = bytes(data)
    want = find_all(text, pat)
    assert 10000 - 3 in want and len(want) >= 6
    results = _run_cluster(tmp_path, text, pat, algo)
    for r in results:
        assert r["process_count"] == 2
        assert r["global_devices"] == 4  # 2 procs x 2 forced CPU devices
        assert r["count"] == len(want)
        assert r["offsets"] == want
        assert r["algo"].endswith("@hosts2")


@pytest.mark.slow
def test_two_process_multihost_pattern_longer_than_slice(tmp_path):
    # m > one host's owned slice: the overlapping file read must extend
    # past the entire next slice boundary region.
    rng = np.random.default_rng(29)
    data = bytearray(rng.integers(97, 123, size=3000, dtype=np.uint8).tobytes())
    pat = bytes(rng.integers(65, 91, size=2000, dtype=np.uint8).tobytes())
    data[500 : 500 + 2000] = pat  # spans the 1500-byte host boundary
    text = bytes(data)
    want = find_all(text, pat)
    assert want == [500]
    results = _run_cluster(tmp_path, text, pat, "boyer_moore")
    for r in results:
        assert r["count"] == 1 and r["offsets"] == [500]


def test_initialize_cluster_rejects_partial_topology():
    # coordinator_address without num_processes used to silently stay
    # single-process and return per-host partial results as global.
    from parallel_implementation_of_string_matching_algorithms_opencl_tpu.parallel import (
        multihost,
    )

    with pytest.raises(ValueError, match="num_processes"):
        multihost.initialize_cluster(
            coordinator_address="localhost:12345", process_id=0
        )


@pytest.mark.slow
@pytest.mark.parametrize("algo", ["boyer_moore", "rabin_karp"])
def test_two_process_streaming_multihost(tmp_path, algo):
    # Config 5 at stated SHAPE: each host STREAMS its owned slice in
    # chunks (never holding size/N in memory), with matches planted at
    # chunk seams AND the host seam, merged by one count-sized two-phase
    # collective round (round-3 VERDICT missing #1).
    chunk = 8192
    size = 9 * chunk + 1234  # odd remainder -> last host absorbs it
    rng = np.random.default_rng(41)
    data = bytearray(rng.integers(97, 101, size=size, dtype=np.uint8).tobytes())
    pat = b"XSEAMX"
    host_seam = 4 * chunk  # host_slice_bounds(size, 0, _, 2, align=chunk)
    plants = [
        0,                       # file start
        chunk - 3,               # chunk seam inside host 0
        2 * chunk + 100,         # host-0 interior
        host_seam - 3,           # THE host seam (straddles ownership)
        host_seam + chunk - 3,   # chunk seam inside host 1
        7 * chunk + 57,          # host-1 interior
        size - len(pat),         # file end
    ]
    for p in plants:
        data[p : p + len(pat)] = pat
    text = bytes(data)
    want = find_all(text, pat)
    assert len(want) == len(plants)
    results = _run_cluster(tmp_path, text, pat, algo,
                           extra_args=("stream", chunk))
    for r in results:
        assert r["process_count"] == 2
        assert r["count"] == len(want)
        assert r["offsets"] == want
        assert r["algo"].endswith("@stream-hosts2")
        assert not r["overflow"]


@pytest.mark.slow
def test_two_process_streaming_multihost_multi_pattern(tmp_path):
    # Several patterns of different lengths in ONE 2-host stream: per-slot
    # counts/overflows and offsets must merge independently and exactly.
    chunk = 8192
    size = 6 * chunk + 777
    rng = np.random.default_rng(43)
    data = bytearray(rng.integers(97, 101, size=size, dtype=np.uint8).tobytes())
    pats = [b"XSEAMX", b"QZ"]
    host_seam = 3 * chunk
    for p in (100, host_seam - 3, size - 6):
        data[p : p + 6] = pats[0]
    for p in (50, chunk - 1, 4 * chunk - 1, 5 * chunk + 9):
        data[p : p + 2] = pats[1]  # chunk seams in both hosts, interiors
    text = bytes(data)
    wants = [find_all(text, p) for p in pats]
    assert len(wants[0]) >= 3 and len(wants[1]) >= 4
    results = _run_cluster(tmp_path, text, pats, "kmp",
                           extra_args=("stream", chunk))
    for r in results:
        assert len(r["all"]) == 2
        for slot, want in zip(r["all"], wants):
            assert slot["count"] == len(want)
            assert slot["offsets"] == want


@pytest.mark.slow
def test_two_process_multihost_drain(tmp_path):
    # Per-host capacity (16) overflow: drain=True must return EVERY
    # offset via per-host windowed re-extraction + the ragged count-sized
    # gather (round-3 VERDICT missing #3 at host scale).
    rng = np.random.default_rng(17)
    data = bytearray(rng.integers(97, 101, size=8000, dtype=np.uint8).tobytes())
    data[100:700] = b"a" * 600       # 599 'aa' in host 0 (> cap 16)
    data[4000 - 1:4000 + 1] = b"aa"  # host-seam straddle
    data[6000:6040] = b"a" * 40      # 39 in host 1
    text = bytes(data)
    want = find_all(text, b"aa")
    assert len(want) > 600
    results = _run_cluster(tmp_path, text, b"aa", "naive",
                           extra_args=("drain",))
    for r in results:
        assert r["count"] == len(want)
        assert r["offsets"] == want
        assert not r["overflow"]


@pytest.mark.slow
def test_two_process_streaming_multihost_drain(tmp_path):
    # Streaming x multihost x DRAIN (round-4 VERDICT missing #1 at host
    # scale): both hosts hit per-chunk capacity-16 overflow in different
    # chunks, including a dense run straddling the host seam; with
    # drain=True the merged global offsets must be complete, sorted and
    # overflow-free on every host.
    chunk = 8192
    size = 6 * chunk + 555
    rng = np.random.default_rng(47)
    data = bytearray(rng.integers(97, 101, size=size, dtype=np.uint8).tobytes())
    host_seam = 3 * chunk
    data[100:700] = b"a" * 600                        # host-0 chunk 0, dense
    data[host_seam - 50 : host_seam + 50] = b"a" * 100  # host-seam dense run
    data[4 * chunk + 9 : 4 * chunk + 209] = b"a" * 200  # host-1 interior
    text = bytes(data)
    want = find_all(text, b"aa")
    assert len(want) > 700
    results = _run_cluster(tmp_path, text, b"aa", "naive",
                           extra_args=("stream_drain", chunk))
    for r in results:
        assert r["process_count"] == 2
        assert r["count"] == len(want)
        assert r["offsets"] == want
        assert not r["overflow"]


def test_allgather_i64_exact_no_truncation():
    # Regression: process_allgather silently downcasts int64->int32 when
    # x64 mode is off, wrapping offsets past 2 GiB negative (caught by the
    # 10 GB 2-process bench: plants at k*512 MiB came back as -2**31).
    # The hi/lo-split gather must round-trip exactly, even single-process.
    from parallel_implementation_of_string_matching_algorithms_opencl_tpu.parallel.multihost import (
        _allgather_i64_exact,
        _allgather_ragged_i64,
    )

    vals = np.array([0, 1, 2**31 - 1, 2**31, 2**33 + 7, 99_999_999_999, -1],
                    np.int64)
    got = _allgather_i64_exact(vals, 1)
    assert got.shape == (1, 7) and np.array_equal(got[0], vals)
    rag = _allgather_ragged_i64(vals[vals >= 0], 1)
    assert np.array_equal(rag, vals[vals >= 0])
