"""Streaming-matcher tests: chunk seams, resume manifest, CLI surface.

Covers SURVEY.md §3.4 (streaming driver) and §5 (checkpoint/resume): matches
planted exactly at chunk boundaries must be reported exactly once, and a run
resumed from the manifest must produce the identical result.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

from conformance.oracle import find_all
from parallel_implementation_of_string_matching_algorithms_opencl_tpu.parallel.streaming import (
    StreamingMatcher,
    match_stream,
)
from parallel_implementation_of_string_matching_algorithms_opencl_tpu.utils.config import (
    MatchConfig,
)
from parallel_implementation_of_string_matching_algorithms_opencl_tpu.utils.io import (
    gen_english,
)

CHUNK = 8192  # small chunks so a modest file spans many
CFG = MatchConfig(capacity=4096, verify_capacity=8192, pad_multiple=1024)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    d = tmp_path_factory.mktemp("stream")
    data = bytearray(gen_english(CHUNK * 5 + 137, seed=21))
    pat = b"XSEAMX"
    # Plant matches straddling every chunk seam at all phases, plus interior.
    for k in range(1, 5):
        for phase in range(-len(pat), 1, 2):
            p = k * CHUNK + phase
            if 0 <= p <= len(data) - len(pat):
                data[p : p + len(pat)] = pat
    data[100 : 100 + len(pat)] = pat
    data[len(data) - len(pat) :] = pat  # match at EOF
    path = d / "corpus.bin"
    path.write_bytes(bytes(data))
    return str(path), bytes(data), pat


@pytest.mark.parametrize("algo", ["naive", "rabin_karp", "kmp", "boyer_moore"])
def test_stream_exact(corpus, algo):
    path, data, pat = corpus
    expected = find_all(data, pat)
    assert len(expected) >= 6
    r = match_stream(path, pat, algo=algo, config=CFG, chunk_bytes=CHUNK)
    assert r.count == len(expected)
    assert [int(x) for x in r.offsets] == expected


def test_stream_single_chunk_file(corpus, tmp_path):
    path, data, pat = corpus
    small = tmp_path / "small.bin"
    small.write_bytes(data[:300])
    expected = find_all(data[:300], pat)
    r = match_stream(str(small), pat, algo="naive", config=CFG, chunk_bytes=CHUNK)
    assert r.count == len(expected)
    assert [int(x) for x in r.offsets] == expected


def test_stream_resume(corpus, tmp_path):
    path, data, pat = corpus
    expected = find_all(data, pat)
    manifest = str(tmp_path / "manifest.json")

    # Simulate an interrupted run: process only the first 2 chunks by
    # driving the internals, saving the manifest as the loop would.
    sm = StreamingMatcher(pat, algo="kmp", config=CFG, chunk_bytes=CHUNK,
                          manifest_path=manifest)
    import jax.numpy as jnp

    sm._journal_reset(0)
    total, entries = 0, 0
    for ci, start, owned_len, valid_n, buf in sm._iter_chunks(path, 0):
        if ci >= 2:
            break
        n_eff = min(valid_n, CHUNK + sm.m - 1)
        count, offsets, ovf = sm._runner(
            jnp.asarray(buf),
            jnp.int32(n_eff),
            sm._pat_dev,
            sm._tables_dev,
        )
        o = np.asarray(offsets)
        kept = o[o >= 0].astype(np.int64) + start
        total += int(count)
        sm._journal_append(kept)
        entries += len(kept)
        sm._save_manifest(path, (0, os.path.getsize(path)), ci + 1, total,
                          entries, False)

    man = json.load(open(manifest))
    assert man["next_chunk"] == 2
    assert man["journal_entries"] == entries
    assert "offsets" not in man  # O(1) manifest: offsets live in the journal

    # Simulate a crash mid-append: a partial trailing record must be
    # truncated away on resume (the manifest's entry count is the truth).
    with open(manifest + ".offsets", "ab") as f:
        f.write(b"\x01\x02\x03")

    r = match_stream(path, pat, algo="kmp", config=CFG, chunk_bytes=CHUNK,
                     manifest_path=manifest, resume=True)
    assert r.count == len(expected)
    assert [int(x) for x in r.offsets] == expected

    # Manifest mismatch (different pattern) must invalidate resume.
    r2 = match_stream(path, b"XSEAMY", algo="kmp", config=CFG,
                      chunk_bytes=CHUNK, manifest_path=manifest, resume=True)
    assert r2.count == len(find_all(data, b"XSEAMY"))


def test_stream_resume_preserves_overflow(corpus, tmp_path):
    # Regression: a resumed run must carry the manifest's per-pattern
    # overflow flags — chunk 0 overflows its capacity, the run is
    # interrupted, and the resumed run (whose own chunks don't overflow)
    # must still report overflow=True rather than a silently-truncated
    # offset list presented as complete.
    path, data, pat = corpus
    dense = tmp_path / "dense.bin"
    # First chunk: 600 'aa' matches (> capacity 16); rest: no matches.
    dense.write_bytes(b"a" * 601 + b"x" * (3 * CHUNK - 601))
    cfg = CFG.replace(capacity=16)
    manifest = str(tmp_path / "ovf_manifest.json")

    sm = StreamingMatcher(b"aa", algo="naive", config=cfg,
                          chunk_bytes=CHUNK, manifest_path=manifest)
    import jax.numpy as jnp

    sm._journal_reset(0)
    for ci, start, owned_len, valid_n, buf in sm._iter_chunks(str(dense), 0):
        count, offsets, ovf = sm._runner(
            jnp.asarray(buf),
            jnp.int32(min(valid_n, CHUNK + sm.m - 1)),
            sm._pat_dev, sm._tables_dev,
        )
        o = np.asarray(offsets)
        kept = o[o >= 0].astype(np.int64) + start
        sm._journal_append(kept)
        assert int(count) == 600 and bool(ovf)
        sm._save_manifest(str(dense), (0, os.path.getsize(str(dense))),
                          ci + 1, int(count), len(kept), True)
        break  # interrupt after chunk 0

    r = match_stream(str(dense), b"aa", algo="naive", config=cfg,
                     chunk_bytes=CHUNK, manifest_path=manifest, resume=True)
    assert r.count == 600
    assert bool(r.overflow), "resume dropped the persisted overflow flag"


@pytest.fixture(scope="module")
def dense_corpus(tmp_path_factory):
    """Corpus engineered so chunk 1 (and the chunk-1/2 seam) massively
    exceeds a capacity-16 offset buffer for pattern 'aa'."""
    d = tmp_path_factory.mktemp("dense")
    data = bytearray(gen_english(CHUNK * 4 + 77, seed=5))
    # Chunk 1 interior: a 700-byte run of 'a' (699 overlapping matches).
    data[CHUNK + 100 : CHUNK + 800] = b"a" * 700
    # A dense run STRADDLING the chunk-1/2 seam: ownership of its matches
    # splits between the two chunks mid-run.
    data[2 * CHUNK - 50 : 2 * CHUNK + 50] = b"a" * 100
    path = d / "dense.bin"
    path.write_bytes(bytes(data))
    return str(path), bytes(data)


def test_stream_drain_overflow_chunk(dense_corpus):
    # Round-4 VERDICT missing #1: an overflowed chunk's offsets were
    # unrecoverable on the streaming path.  With drain=True every oracle
    # offset must come back, in order, with overflow=False — including the
    # matches whose ownership splits across the seam inside a dense run.
    path, data = dense_corpus
    want = find_all(data, b"aa")
    assert len(want) > 700  # far past capacity 16
    cfg = CFG.replace(capacity=16)
    r = match_stream(path, b"aa", algo="naive", config=cfg,
                     chunk_bytes=CHUNK, drain=True)
    assert r.count == len(want)
    assert [int(x) for x in r.offsets] == want
    assert not r.overflow

    # Control: without drain the same stream must FLAG the truncation.
    r0 = match_stream(path, b"aa", algo="naive", config=cfg,
                      chunk_bytes=CHUNK)
    assert r0.count == len(want) and r0.overflow


@pytest.mark.parametrize("algo", ["rabin_karp", "kmp", "boyer_moore"])
def test_stream_drain_all_algos(dense_corpus, algo):
    # The drain path routes through each algorithm's own extract_range
    # (screened candidate re-verify for BM/RK, prefix screen for KMP).
    path, data = dense_corpus
    want = find_all(data, b"aab")
    cfg = CFG.replace(capacity=4)
    r = match_stream(path, b"aab", algo=algo, config=cfg,
                     chunk_bytes=CHUNK, drain=True)
    assert r.count == len(want)
    assert [int(x) for x in r.offsets] == want
    assert not r.overflow


def test_stream_drain_multi_pattern_journal(dense_corpus, tmp_path):
    # Multi-pattern: 'aa' (overflows, shared-hash RK group member) and
    # 'ab' (fits) stream in ONE pass; the drain must rebuild a
    # single-pattern matcher for the overflowing group member while the
    # non-overflowing slot keeps its fast path.  Journaled variant.
    path, data = dense_corpus
    pats = [b"aa", b"ab"]
    cfg = CFG.replace(capacity=16)
    manifest = str(tmp_path / "drain_multi.json")
    results = match_stream(path, pats, algo="rabin_karp", config=cfg,
                           chunk_bytes=CHUNK, manifest_path=manifest,
                           drain=True)
    for p, r in zip(pats, results):
        want = find_all(data, p)
        assert r.count == len(want), p
        assert [int(x) for x in r.offsets] == want, p
        assert not r.overflow, p


def test_stream_drain_resume(dense_corpus, tmp_path):
    # Resume ACROSS a drained chunk: chunk 0 is processed (with chunk 1's
    # dense region moved to chunk 0 via a truncated iterator), the run is
    # interrupted, and the resumed run must splice its remaining chunks
    # after the drained journal without duplicating or losing offsets.
    path, data = dense_corpus
    want = find_all(data, b"aa")
    cfg = CFG.replace(capacity=16)
    manifest = str(tmp_path / "drain_resume.json")

    class _Interrupted(StreamingMatcher):
        def _iter_chunks(self, path, start_chunk, range_start=0,
                         range_stop=None):
            for item in super()._iter_chunks(path, start_chunk,
                                             range_start, range_stop):
                if item[0] >= 2:  # stop before chunk 2: chunk 1 drained
                    return
                yield item

    sm = _Interrupted(b"aa", algo="naive", config=cfg, chunk_bytes=CHUNK,
                      manifest_path=manifest)
    partial = sm.match_file(path, drain=True)
    assert partial.count < len(want)  # genuinely interrupted
    man = json.load(open(manifest))
    assert man["next_chunk"] == 2
    assert man["overflow"] is False  # chunk 1 overflow was drained

    r = match_stream(path, b"aa", algo="naive", config=cfg,
                     chunk_bytes=CHUNK, manifest_path=manifest,
                     resume=True, drain=True)
    assert r.count == len(want)
    assert [int(x) for x in r.offsets] == want
    assert not r.overflow


def test_stream_multi_pattern(corpus, tmp_path):
    # One pass over the file serves several patterns (config 2 shape):
    # equal-length RK patterns share one rolling-hash pass; mixed lengths
    # group by length.  Per-pattern ownership must hold at chunk seams.
    path, data, pat = corpus
    pats = [pat, b"the ", b"e qu", bytes(data[CHUNK - 2 : CHUNK + 2])]
    manifest = str(tmp_path / "multi.json")
    cfg = CFG.replace(capacity=1 << 15, verify_capacity=1 << 15)
    results = match_stream(path, pats, algo="rabin_karp", config=cfg,
                           chunk_bytes=CHUNK, manifest_path=manifest)
    assert isinstance(results, list) and len(results) == len(pats)
    for p, r in zip(pats, results):
        want = find_all(data, p)
        assert r.count == len(want), p
        assert [int(x) for x in r.offsets] == want, p
    man = json.load(open(manifest))
    assert len(man["count"]) == len(pats)

    # Multi-pattern resume: identical results from a warm manifest.
    results2 = match_stream(path, pats, algo="rabin_karp", config=cfg,
                            chunk_bytes=CHUNK, manifest_path=manifest,
                            resume=True)
    for r, r2 in zip(results, results2):
        assert r2.count == r.count
        assert [int(x) for x in r2.offsets] == [int(x) for x in r.offsets]


def test_stream_multi_pattern_kmp(corpus):
    # Non-RK algorithms stream multi-pattern too (one unit per pattern).
    path, data, pat = corpus
    pats = [pat, b"q"]
    results = match_stream(path, pats, algo="kmp", config=CFG,
                           chunk_bytes=CHUNK)
    for p, r in zip(pats, results):
        want = find_all(data, p)
        assert r.count == len(want) and [int(x) for x in r.offsets] == want


def test_cli_basic(corpus, tmp_path):
    path, data, pat = corpus
    expected = find_all(data, pat)
    env = dict(os.environ)
    env["XLA_FLAGS"] = (env.get("XLA_FLAGS", "") + " --xla_force_host_platform_device_count=8").strip()
    env["JAX_PLATFORMS"] = ""
    # cli.py imports jax lazily inside main(); force CPU via conftest-style
    # is unavailable in a subprocess, so use a wrapper -c that flips first.
    code = (
        "import jax; jax.config.update('jax_platforms','cpu');"
        "import sys; sys.argv = ['cli.py','kmp',%r,%r,'--json'];"
        "import cli; sys.exit(cli.main(sys.argv[1:]))" % (path, pat.decode())
    )
    out = subprocess.run(
        [sys.executable, "-c", code],
        capture_output=True, text=True, env=env,
        cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    )
    assert out.returncode == 0, out.stderr[-2000:]
    obj = json.loads(out.stdout.strip().splitlines()[-1])
    assert obj["count"] == len(expected)
    assert obj["offsets"][: len(expected)] == expected[:20]


def test_cli_stream_drain(dense_corpus):
    # --drain now composes with --stream (the r4 hard-error is lifted):
    # capacity-16 chunks overflow, the drain recovers every offset.
    path, data = dense_corpus
    want = find_all(data, b"aa")
    code = (
        "import jax; jax.config.update('jax_platforms','cpu');"
        "import sys; import cli;"
        "sys.exit(cli.main(['naive',%r,'aa','--stream','--chunk-mb','1',"
        "'--capacity','16','--drain','--json','--offsets','-1']))" % path
    )
    out = subprocess.run(
        [sys.executable, "-c", code],
        capture_output=True, text=True, env=dict(os.environ),
        cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    )
    assert out.returncode == 0, out.stderr[-2000:]
    obj = json.loads(out.stdout.strip().splitlines()[-1])
    assert obj["count"] == len(want)
    assert obj["offsets"] == want
    assert not obj["overflow"]


def test_cli_stream_and_count_only(corpus, tmp_path):
    path, data, pat = corpus
    expected = find_all(data, pat)
    env = dict(os.environ)
    code = (
        "import jax; jax.config.update('jax_platforms','cpu');"
        "import sys; import cli;"
        "sys.exit(cli.main(['naive',%r,%r,'--stream','--chunk-mb','1','--count-only']))"
        % (path, pat.decode())
    )
    out = subprocess.run(
        [sys.executable, "-c", code],
        capture_output=True, text=True, env=env,
        cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    )
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip() == str(len(expected))
