#!/usr/bin/env python
"""Acceptance-config measurement matrix (BASELINE.json:7-11, SURVEY.md §6).

Runs the five configs of BASELINE.json (scaled by --scale so smoke runs
finish in minutes) and appends structured rows to BENCH_MATRIX.json:

  1. naive, single 16-byte ASCII pattern, English corpus, CPU-jax backend,
     exact offset parity vs the oracle
  2. Rabin-Karp, 8 patterns, large corpus, single chip
  3. KMP, pattern lengths 4..256, 1-host data-parallel shards with halo
  4. Boyer-Moore, DNA and UTF-8 corpora, full host
  5. all four algorithms, sharded corpus with psum count reduction and
     offset all-gather over the device mesh (cross-host runs only change
     the process bootstrap, parallel/multihost.py)

Usage: python bench/matrix.py [--scale 0.05] [--configs 1,2,3,4,5]
(--scale 1.0 = the full BASELINE sizes: 100MB/1GB/100GB-class).
"""

from __future__ import annotations

import argparse
import os as _os
import sys as _sys

_sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))))
import json
import sys
import time


ROW_EXTRA: dict = {}  # device/scale stamped on every row (set in main)
CHECKOUT = _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__)))


def emit(row):
    """Print one row and append it to BENCH_MATRIX.json (not committed)."""
    row = {**row, **ROW_EXTRA}
    print(json.dumps(row), flush=True)
    with open("BENCH_MATRIX.json", "a") as f:
        f.write(json.dumps(row) + "\n")


def timed_match(fn, *args, iters=3, **kw):
    import jax

    r = fn(*args, **kw)  # warm/compile
    t0 = time.perf_counter()
    for _ in range(iters):
        r = fn(*args, **kw)
    wall = (time.perf_counter() - t0) / iters
    return r, wall


# -- staged timing -----------------------------------------------------------
#
# The scan metric (BASELINE.json:2 bytes/s/chip) is the DEVICE-RESIDENT rate:
# buffers are staged to device memory once and the jitted runner is timed per
# call, wall clock around calls that end in block_until_ready.  The one-time
# host->device transfer is reported separately as h2d_s.


def _stage(text_np, sharding=None):
    import jax

    t0 = time.perf_counter()
    text_dev = jax.block_until_ready(
        jax.device_put(text_np, sharding) if sharding
        else jax.device_put(text_np))
    return text_dev, time.perf_counter() - t0


def _time_runner(runner, text_dev, n, pat_dev, tb_dev, iters=6):
    """(output, best per-call wall): one warm call (the parity source),
    then ``iters`` timed calls, each ended by block_until_ready."""
    import jax
    import jax.numpy as jnp

    args = (text_dev, jnp.int32(n), pat_dev, tb_dev)
    out = jax.block_until_ready(runner(*args))
    walls = []
    for _ in range(iters):
        t0 = time.perf_counter()
        jax.block_until_ready(runner(*args))
        walls.append(time.perf_counter() - t0)
    return out, min(walls)


def _cap(estimate: float) -> int:
    """Offset capacity: next power of two above the expected match count
    (big fixed caps compile huge extraction branches for nothing)."""
    return max(1 << 16, 1 << int(estimate * 2).bit_length())


def _single_result(matcher, out):
    """(count, sorted offsets list) from a single-pattern runner output."""
    import numpy as np

    count = int(out[0])
    offs = np.asarray(out[1])
    return count, [int(x) for x in offs[offs >= 0]]


def config1(scale):
    """Naive / 16B ASCII / English / CPU-jax backend / exact parity."""
    import numpy as np

    from conformance.oracle import find_all
    from parallel_implementation_of_string_matching_algorithms_opencl_tpu import match
    from parallel_implementation_of_string_matching_algorithms_opencl_tpu.utils.io import (
        gen_english,
    )

    n = int(100e6 * scale)
    text = gen_english(n, seed=1)
    pat = b"quick brown fox "
    assert len(pat) == 16
    r, wall = timed_match(match, text, pat, algo="naive")
    expected = find_all(text, pat)
    parity = r.count == len(expected) and r.offsets_list() == expected
    emit(
        {
            "config": 1,
            "algo": "naive",
            "n_bytes": n,
            "wall_s": wall,
            "bytes_per_s": n / wall,
            "match_count": r.count,
            "exact_parity": bool(parity),
        }
    )
    assert parity, "config 1 parity FAILED"


def config2(scale):
    """Rabin-Karp multi-pattern (8) / single chip."""
    import numpy as np

    from conformance.oracle import find_all
    from parallel_implementation_of_string_matching_algorithms_opencl_tpu.models.multi import (
        RabinKarpMultiMatcher,
    )
    from parallel_implementation_of_string_matching_algorithms_opencl_tpu.utils.config import (
        MatchConfig,
    )
    from parallel_implementation_of_string_matching_algorithms_opencl_tpu.utils.io import (
        gen_english,
        pad_to_multiple,
    )
    import jax
    import jax.numpy as jnp

    n = int(1e9 * scale)
    text = gen_english(n, seed=2)
    # Half synthetic phrases, half drawn from the corpus so several
    # patterns have real (nonzero) match counts.
    pats = [
        b"quick brown fox ", b"lazy dog and cat", b"parallel device ",
        b"search algorithm",
        text[1000:1016], text[n // 2 : n // 2 + 16],
        text[n // 3 : n // 3 + 16], text[n - 4096 : n - 4080],
    ]
    cap = _cap(2e-4 * n)  # corpus-drawn 16-byte patterns: ~1.5e-4 matches/B
    cfg = MatchConfig(capacity=cap, verify_capacity=cap)
    mm = RabinKarpMultiMatcher(pats, cfg)
    # Pad as matcher.match() does, so the staged runner sees the same shape.
    text_np = pad_to_multiple(np.frombuffer(text, np.uint8), cfg.pad_multiple)
    runner = mm._runner(cfg, mm.k)
    text_dev, h2d = _stage(text_np)
    pat_dev = jnp.asarray(mm.pattern_arr)
    tb_dev = jax.tree.map(jnp.asarray, mm.tables)
    out, wall = _time_runner(runner, text_dev, n, pat_dev, tb_dev)
    counts = [int(c) for c in np.asarray(out[0])]
    offs = np.asarray(out[1])
    ok = True
    for p_i, p in enumerate(pats):
        want = find_all(text, p)
        o = offs[p_i]
        ok &= (counts[p_i] == len(want)
               and [int(x) for x in o[o >= 0]] == want)
    emit(
        {
            "config": 2,
            "algo": "rabin_karp_multi8",
            "n_bytes": n,
            "wall_s": wall,
            "bytes_per_s": n / wall,
            "h2d_s": h2d,
            "match_counts": counts,
            "exact_parity": bool(ok),
        }
    )
    assert ok, "config 2 parity FAILED"


def config3(scale):
    """KMP / pattern lengths 4..256 / data-parallel shards with halo."""
    import numpy as np

    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from conformance.oracle import find_all
    from parallel_implementation_of_string_matching_algorithms_opencl_tpu.parallel.dist import (
        DistributedMatcher,
    )
    from parallel_implementation_of_string_matching_algorithms_opencl_tpu.parallel.mesh import (
        DATA_AXIS,
        make_data_mesh,
    )
    from parallel_implementation_of_string_matching_algorithms_opencl_tpu.utils.config import (
        MatchConfig,
    )
    from parallel_implementation_of_string_matching_algorithms_opencl_tpu.utils.io import (
        gen_english,
        pad_to_multiple,
    )

    n = int(100e6 * scale)
    text = bytearray(gen_english(n, seed=3))
    mesh = make_data_mesh()
    d = mesh.shape[DATA_AXIS]
    sharding = NamedSharding(mesh, P(DATA_AXIS))
    text_np = pad_to_multiple(
        np.frombuffer(bytes(text), np.uint8), MatchConfig().pad_multiple * d
    )
    text_dev, h2d = _stage(text_np, sharding)
    for m in (4, 16, 64, 256):
        # m=4 on english matches ~5e-3/byte (~500k at 100MB) — capacity
        # sized to verify the FULL offset list (counts exact regardless).
        cap = _cap((8e-3 if m == 4 else 2e-4) * n)
        cfg = MatchConfig(capacity=cap, verify_capacity=cap)
        pat = bytes(text[5000 : 5000 + m])
        dm = DistributedMatcher(pat, algo="kmp", config=cfg, mesh=mesh)
        runner = dm._build(mesh, type(dm.matcher), dm.config, m)
        pat_dev = jnp.asarray(dm.matcher.pattern_arr)
        tb_dev = jax.tree.map(jnp.asarray, dm.matcher.tables)
        out, wall = _time_runner(runner, text_dev, n, pat_dev, tb_dev)
        count, _ovf, _scounts, rows = dm.resolve_runner_output(out)
        offs = rows.reshape(-1)
        got = sorted(int(x) for x in offs[offs >= 0])
        expected = find_all(bytes(text), pat)
        ok = count == len(expected) and got == expected
        # Apples-to-apples control (round-4 VERDICT weak #3 compared these
        # dist rows against 256 MiB single-chip numbers, where flat
        # extraction costs amortize differently): the SAME text, SAME
        # window, single-chip runner.  dist/single ratio is then pure
        # wrapper cost.
        single_wall = None
        if d == 1 and m >= 64:
            sm_ = dm.matcher
            srun = sm_._runner(sm_.config)
            td1, _ = _stage(text_np)
            _, single_wall = _time_runner(srun, td1, n, pat_dev, tb_dev)
            del td1
        row = {
            "config": 3,
            "algo": f"kmp_dist_m{m}",
            "n_bytes": n,
            "wall_s": wall,
            "bytes_per_s": n / wall,
            "h2d_s": h2d,
            "match_count": count,
            "exact_parity": bool(ok),
        }
        if single_wall is not None:
            row["single_wall_s"] = single_wall
            row["dist_over_single"] = round(wall / single_wall, 3)
        emit(row)
        assert ok, f"config 3 parity FAILED m={m}"


def config4(scale):
    """Boyer-Moore / DNA + UTF-8 corpora / full host."""
    from conformance.oracle import find_all
    from parallel_implementation_of_string_matching_algorithms_opencl_tpu import match
    from parallel_implementation_of_string_matching_algorithms_opencl_tpu.utils.io import (
        gen_dna,
        gen_utf8,
    )

    import numpy as np

    import jax
    import jax.numpy as jnp

    from parallel_implementation_of_string_matching_algorithms_opencl_tpu.models.registry import (
        get_matcher,
    )
    from parallel_implementation_of_string_matching_algorithms_opencl_tpu.utils.config import (
        MatchConfig,
    )
    from parallel_implementation_of_string_matching_algorithms_opencl_tpu.utils.io import (
        pad_to_multiple,
    )

    n = int(100e6 * scale)
    cap = _cap(1e-4 * n)
    cfg = MatchConfig(capacity=cap, verify_capacity=cap)
    for name, corpus in (
        ("dna", gen_dna(n, seed=4)),
        ("utf8", gen_utf8(n // 2, seed=4)),
    ):
        pat = corpus[1000:1024]  # 24-byte pattern drawn from the corpus
        matcher = get_matcher("boyer_moore")(pat, cfg)
        runner = matcher._runner(matcher.config)
        text_np = pad_to_multiple(np.frombuffer(corpus, np.uint8),
                                  cfg.pad_multiple)
        text_dev, h2d = _stage(text_np)
        pat_dev = jnp.asarray(matcher.pattern_arr)
        tb_dev = jax.tree.map(jnp.asarray, matcher.tables)
        out, wall = _time_runner(runner, text_dev, len(corpus), pat_dev,
                                 tb_dev)
        count, got = _single_result(matcher, out)
        expected = find_all(corpus, pat)
        ok = count == len(expected) and got == expected
        emit(
            {
                "config": 4,
                "algo": f"boyer_moore_{name}",
                "n_bytes": len(corpus),
                "wall_s": wall,
                "bytes_per_s": len(corpus) / wall,
                "h2d_s": h2d,
                "match_count": count,
                "exact_parity": bool(ok),
            }
        )
        assert ok, f"config 4 parity FAILED ({name})"


def _gen_corpus_file(path: str, total: int, pat: bytes, seed: int = 5,
                     plant_every: int = 1 << 30):
    """Write a ``total``-byte English corpus to ``path`` in 64 MiB segments
    (bounded RAM), planting ``pat`` at every ``plant_every`` boundary and at
    EOF.  Returns the list of planted offsets."""
    from parallel_implementation_of_string_matching_algorithms_opencl_tpu.utils.io import (
        gen_english,
    )

    seg = 64 << 20
    planted = []
    with open(path, "wb") as f:
        written = 0
        si = 0
        while written < total:
            chunk = bytearray(gen_english(min(seg, total - written),
                                          seed=seed + si))
            # plant at plant_every boundaries that fall inside this segment
            lo, hi = written, written + len(chunk)
            k = -(-lo // plant_every)
            while k * plant_every + len(pat) <= hi:
                off = k * plant_every - lo
                if off >= 0:
                    chunk[off : off + len(pat)] = pat
                    planted.append(k * plant_every)
                k += 1
            if hi == total and len(chunk) >= len(pat):
                chunk[-len(pat):] = pat
                # The EOF plant may partially overwrite an already-recorded
                # boundary plant; drop any recorded offset it clobbered so
                # the planted-subset parity check can't fail on a
                # corpus-generation artifact.
                planted = [o for o in planted
                           if o + len(pat) <= total - len(pat)]
                planted.append(total - len(pat))
            f.write(chunk)
            written = hi
            si += 1
    return sorted(set(planted))


def config5(scale, stream_bytes: int | None = None,
            dist_bytes: int | None = None):
    """All four algorithms / sharded corpus / psum + all-gather merge.

    On a pod this runs across N>=2 hosts via parallel/multihost.py; the
    collective path here is identical (shard_map over the data mesh).
    Streaming covers the out-of-HBM sizes: the in-memory distributed part
    runs at min(n, 1GB); the streaming part at ``stream_bytes`` (default n)
    with the corpus generated straight to disk in 64 MiB segments.
    """
    import os

    from conformance.oracle import find_all
    from parallel_implementation_of_string_matching_algorithms_opencl_tpu import (
        match_distributed,
        match_stream,
    )
    from parallel_implementation_of_string_matching_algorithms_opencl_tpu.utils.io import (
        gen_english,
    )

    import numpy as np

    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from parallel_implementation_of_string_matching_algorithms_opencl_tpu.parallel.dist import (
        DistributedMatcher,
    )
    from parallel_implementation_of_string_matching_algorithms_opencl_tpu.parallel.mesh import (
        DATA_AXIS,
        make_data_mesh,
    )
    from parallel_implementation_of_string_matching_algorithms_opencl_tpu.utils.config import (
        MatchConfig,
    )
    from parallel_implementation_of_string_matching_algorithms_opencl_tpu.utils.io import (
        pad_to_multiple,
    )

    n = dist_bytes or min(int(1e9 * scale), 1 << 30)
    text = gen_english(n, seed=5)
    pat = b"shard merge psum"
    text = text[: n - 16] + pat  # ensure >= 1 match
    expected = find_all(text, pat)
    cfg = MatchConfig()
    mesh = make_data_mesh()
    d = mesh.shape[DATA_AXIS]
    sharding = NamedSharding(mesh, P(DATA_AXIS))
    text_np = pad_to_multiple(
        np.frombuffer(text, np.uint8), cfg.pad_multiple * d
    )
    text_dev, h2d = _stage(text_np, sharding)
    for algo in ("naive", "rabin_karp", "kmp", "boyer_moore"):
        dm = DistributedMatcher(pat, algo=algo, config=cfg, mesh=mesh)
        runner = dm._build(mesh, type(dm.matcher), dm.config, dm.m)
        pat_dev = jnp.asarray(dm.matcher.pattern_arr)
        tb_dev = jax.tree.map(jnp.asarray, dm.matcher.tables)
        out, wall = _time_runner(runner, text_dev, n, pat_dev, tb_dev)
        count, _ovf, _scounts, rows = dm.resolve_runner_output(out)
        offs = rows.reshape(-1)
        got = sorted(int(x) for x in offs[offs >= 0])
        ok = count == len(expected) and got == expected
        emit(
            {
                "config": 5,
                "algo": f"{algo}_dist",
                "n_bytes": n,
                "wall_s": wall,
                "bytes_per_s": n / wall,
                "h2d_s": h2d,
                "match_count": count,
                "exact_parity": bool(ok),
            }
        )
        assert ok, f"config 5 parity FAILED ({algo})"
    del text, text_dev

    # Streaming variant (chunked, resume-capable, BASELINE 100GB-class):
    # corpus generated straight to disk; parity = planted offsets are a
    # subset of results + spot-window oracle checks (a full in-RAM oracle
    # at 10-100GB would dominate the run).
    sn = stream_bytes or int(1e9 * scale)
    path = os.path.join(CHECKOUT, ".corpora", f"c5_{sn}.bin")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    t0 = time.perf_counter()
    planted = _gen_corpus_file(path, sn, pat, seed=5, plant_every=1 << 29)
    print(f"  corpus gen: {sn / 1e9:.1f} GB in {time.perf_counter() - t0:.0f}s",
          file=sys.stderr)
    try:
        t0 = time.perf_counter()
        r = match_stream(path, pat, algo="boyer_moore", chunk_bytes=256 << 20)
        wall = time.perf_counter() - t0
        got = set(int(x) for x in r.offsets)
        ok = set(planted).issubset(got) and r.count >= len(planted)
        # spot-check windows around three planted offsets + one random range
        mm = __import__("numpy").memmap(path, dtype="u1", mode="r")
        for off in planted[:3]:
            lo = max(0, off - 4096)
            win = bytes(mm[lo : off + 4096 + len(pat)])
            w_want = [x + lo for x in find_all(win, pat)]
            w_got = [x for x in got if lo <= x <= off + 4096]
            ok &= sorted(w_got) == sorted(
                x for x in w_want if lo <= x <= off + 4096
            )
        del mm
        emit(
            {
                "config": 5,
                "algo": "boyer_moore_stream",
                "n_bytes": sn,
                "wall_s": wall,
                "bytes_per_s": sn / wall,
                "match_count": r.count,
                "exact_parity": bool(ok),
                "parity_mode": "planted-subset+spot-windows",
            }
        )
        assert ok, "config 5 streaming parity FAILED"
    finally:
        os.unlink(path)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--scale", type=float, default=0.05)
    ap.add_argument("--configs", default="1,2,3,4,5")
    ap.add_argument("--c5-stream-gb", type=float, default=0.0,
                    help="config-5 streaming corpus size in GB (0 = scale*1GB)")
    ap.add_argument("--c5-dist-mb", type=int, default=0,
                    help="config-5 in-memory distributed size in MB "
                         "(0 = scale*1GB; cap it on the CPU mesh, whose "
                         "8 device threads share 4 cores and trip XLA's "
                         "40s collective-rendezvous timeout at ~1GB)")
    ap.add_argument("--cpu", action="store_true",
                    help="force the CPU jax backend with an 8-device mesh "
                         "(config 1 spec; config 5 collective path)")
    args = ap.parse_args()

    import os

    if args.cpu:
        os.environ["XLA_FLAGS"] = (
            os.environ.get("XLA_FLAGS", "")
            + " --xla_force_host_platform_device_count=8"
        ).strip()

    import jax

    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
    from parallel_implementation_of_string_matching_algorithms_opencl_tpu.utils.cache import (  # noqa: E501
        enable_compile_cache,
    )

    enable_compile_cache()
    print(f"devices: {jax.devices()}", file=sys.stderr)
    dev = jax.devices()[0]
    ROW_EXTRA.update(
        device=f"{dev.platform}/{dev.device_kind}",
        n_devices=len(jax.devices()),
        scale=args.scale,
    )

    fns = {"1": config1, "2": config2, "3": config3, "4": config4}
    for c in args.configs.split(","):
        print(f"--- config {c} (scale {args.scale}) ---", file=sys.stderr)
        if c == "5":
            sb = int(args.c5_stream_gb * 1e9) or None
            db = args.c5_dist_mb * (1 << 20) or None
            config5(args.scale, stream_bytes=sb, dist_bytes=db)
        else:
            fns[c](args.scale)


if __name__ == "__main__":
    main()
