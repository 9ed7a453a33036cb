#!/usr/bin/env python
"""End-to-end smoke run of tpumatch on one NVIDIA GPU.

    python chip_smoke.py           # phases 1-7 on one card
    python chip_smoke.py --four    # match_distributed on a 4-card mesh only

Every phase goes through the public entry points (``match``,
``match_stream``, ``match_distributed``) at full size and compares every
count and offset with ``conformance.oracle.find_all``.  Each phase prints
its cold wall (compile included), warm wall, counts, ``exact`` and the
device's peak bytes in use.  The last line of standard output is one JSON
object, printed only when every phase passed:

    {"ok": true, "device": {"platform": "gpu", "kind": "...", "count": 1}}

The script fails (exit code 1, no JSON line) when JAX finds no GPU or the
package cannot be imported.

Phases (one card): 1 headline (four algorithms, 256 MiB English, m=16);
2 config 2 (Rabin-Karp, 8 patterns, 1 GiB); 3 config 3 (KMP m=4/64/256);
4 config 4 (Boyer-Moore on DNA and UTF-8); 5 streaming (>= 1 GiB file in
256 MiB chunks); 6 the tests marked ``gpu``; 7 every MatchConfig variant
at 16 MiB.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
import traceback

MiB = 1 << 20
HEADLINE = b"quick brown fox "
ALGOS = ("naive", "rabin_karp", "kmp", "boyer_moore")


def log(**row) -> None:
    print(json.dumps(row), flush=True)


def card_line() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60,
        )
        return out.stdout.strip() or out.stderr.strip()
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi unavailable: {e}"


class Smoke:
    """Runs phases, keeps going after a failure, remembers every one."""

    def __init__(self, jax):
        self.jax = jax
        self.failures: list[str] = []

    def peak(self) -> int | None:
        stats = self.jax.devices()[0].memory_stats() or {}
        return stats.get("peak_bytes_in_use")

    def phase(self, name, fn) -> None:
        print(f"--- {name}", flush=True)
        try:
            fn()
        except Exception:
            traceback.print_exc()
            self.failures.append(f"{name}: raised")

    def timed(self, fn, warm_reps: int = 2):
        """(result, cold_s, warm_s): first call compiles; warm is the
        best of ``warm_reps`` later calls (each ends on host results)."""
        t0 = time.perf_counter()
        out = fn()
        cold = time.perf_counter() - t0
        warm = None
        for _ in range(warm_reps):
            t0 = time.perf_counter()
            out = fn()
            dt = time.perf_counter() - t0
            warm = dt if warm is None else min(warm, dt)
        return out, cold, warm

    def check(self, name, results, expected, cold=None, warm=None,
              n_bytes=None, **extra) -> None:
        """Compare one MatchResult (or a list) with oracle offsets."""
        if not isinstance(results, list):
            results, expected = [results], [expected]
        exact = all(
            r.count == len(e) and r.offsets_list() == e and not r.overflow
            for r, e in zip(results, expected)
        ) and len(results) == len(expected)
        log(phase=name, cold_s=cold, warm_s=warm, n_bytes=n_bytes,
            counts=[r.count for r in results], exact=exact,
            peak_bytes_in_use=self.peak(), **extra)
        if not exact:
            self.failures.append(name)

    def expect(self, name, ok: bool, **extra) -> None:
        log(phase=name, exact=bool(ok), peak_bytes_in_use=self.peak(),
            **extra)
        if not ok:
            self.failures.append(name)


def one_card(smoke: Smoke, pkg) -> None:
    import numpy as np

    from conformance.oracle import find_all

    jax = smoke.jax
    match, match_stream = pkg.match, pkg.match_stream
    MatchConfig = pkg.MatchConfig
    io = pkg.utils.io

    t0 = time.perf_counter()
    english = io.gen_english(256 * MiB, seed=42)
    english_1g = io.gen_english(1024 * MiB, seed=2)
    dna = io.gen_dna(256 * MiB, seed=4)
    utf8 = io.gen_utf8(126_000_000, seed=4)[: 256 * MiB]
    log(phase="corpora", gen_s=time.perf_counter() - t0,
        sizes=[len(english), len(english_1g), len(dna), len(utf8)])
    want_headline = find_all(english, HEADLINE)

    def headline():
        for algo in ALGOS:
            r, cold, warm = smoke.timed(
                lambda: match(english, HEADLINE, algo=algo))
            smoke.check(f"1/headline/{algo}", r, want_headline, cold, warm,
                        len(english))

    smoke.phase("1 headline: 256 MiB English, m=16", headline)

    pats2 = [
        b"quick brown fox ", b"lazy dog and cat", b"parallel device ",
        b"search algorithm", english_1g[1000:1016],
        english_1g[len(english_1g) // 2:len(english_1g) // 2 + 16],
        english_1g[len(english_1g) // 3:len(english_1g) // 3 + 16],
        english_1g[-4096:-4080],
    ]
    cfg2 = MatchConfig(capacity=1 << 18, verify_capacity=1 << 18)

    def config2():
        want = [find_all(english_1g, p) for p in pats2]
        rs, cold, warm = smoke.timed(
            lambda: match(english_1g, pats2, algo="rabin_karp", config=cfg2),
            warm_reps=1)
        mm = pkg.models.RabinKarpMultiMatcher(pats2, cfg2)
        padded = io.pad_to_multiple(
            np.frombuffer(english_1g, np.uint8), cfg2.pad_multiple)
        mem = mm._runner(cfg2, mm.k).lower(
            padded, np.int32(len(english_1g)), mm.pattern_arr, mm.tables,
        ).compile().memory_analysis()
        print(f"config 2 memory_analysis: {mem}", flush=True)
        smoke.check("2/rabin_karp_x8/1GiB", rs, want, cold, warm,
                    len(english_1g))

    smoke.phase("2 config 2: Rabin-Karp, 8 patterns, 1 GiB", config2)

    def config3():
        for m in (4, 64, 256):
            pat = english[5000:5000 + m]
            want = find_all(english, pat)
            r, cold, warm = smoke.timed(
                lambda: match(english, pat, algo="kmp"), warm_reps=1)
            count_ok = r.count == len(want)
            if r.overflow:  # match-dense: the exact count, then drain
                smoke.expect(f"3/kmp/m={m}/count", count_ok, count=r.count,
                             cold_s=cold, warm_s=warm, overflow=True)
                t0 = time.perf_counter()
                r = match(english, pat, algo="kmp", drain=True)
                smoke.check(f"3/kmp/m={m}/drain", r, want,
                            warm=time.perf_counter() - t0,
                            n_bytes=len(english))
            else:
                smoke.check(f"3/kmp/m={m}", r, want, cold, warm,
                            len(english))

    smoke.phase("3 config 3: KMP m=4/64/256, 256 MiB", config3)

    def config4():
        for name, text in (("dna", dna), ("utf8", utf8)):
            pat = text[1000:1024]
            r, cold, warm = smoke.timed(
                lambda: match(text, pat, algo="boyer_moore"), warm_reps=1)
            smoke.check(f"4/boyer_moore/{name}", r, find_all(text, pat),
                        cold, warm, len(text))

    smoke.phase("4 config 4: Boyer-Moore, DNA and UTF-8", config4)

    def streaming():
        d = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         ".corpora")
        os.makedirs(d, exist_ok=True)
        path = os.path.join(d, "chip_smoke_stream.bin")
        data = english_1g + english[: 3 * MiB + 7]
        with open(path, "wb") as f:
            f.write(data)
        try:
            t0 = time.perf_counter()
            sm = pkg.parallel.streaming.StreamingMatcher(
                HEADLINE, algo=list(ALGOS), chunk_bytes=256 * MiB)
            rs = sm.match_file(path)
            want = find_all(data, HEADLINE)
            smoke.check("5/stream/4-algos", rs, [want] * len(ALGOS),
                        warm=time.perf_counter() - t0, n_bytes=len(data),
                        stats=sm.last_stats)
            t0 = time.perf_counter()
            rs = match_stream(path, pats2, algo="rabin_karp", config=cfg2,
                              chunk_bytes=256 * MiB)
            smoke.check("5/stream/rabin_karp_x8", rs,
                        [find_all(data, p) for p in pats2],
                        warm=time.perf_counter() - t0, n_bytes=len(data))
        finally:
            os.unlink(path)

    smoke.phase("5 streaming: 1 GiB + 3 MiB file, 256 MiB chunks",
                streaming)

    def gpu_tests():
        import pytest

        rc = pytest.main(["-q", "-m", "gpu", "-p", "no:cacheprovider",
                          os.path.join(os.path.dirname(
                              os.path.abspath(__file__)), "tests")])
        smoke.expect("6/pytest -m gpu", rc == 0, pytest_rc=int(rc))

    smoke.phase("6 card-only tests", gpu_tests)

    def variants():
        text = english[: 16 * MiB]
        pat = HEADLINE
        want = find_all(text, pat)
        dense = english[5000:5004]
        want_dense = find_all(text, dense)
        cases = [
            ("boyer_moore", pat, MatchConfig(bm_variant="cursor"), False),
            ("boyer_moore", pat, MatchConfig(bm_variant="cursor",
                                             bm_chunk=1024), False),
            ("boyer_moore", pat, MatchConfig(bm_variant="filtered"), False),
            ("kmp", pat, MatchConfig(kmp_chunk=256), False),
            ("kmp", dense, MatchConfig(kmp_chunk=64, capacity=256), True),
            ("rabin_karp", pat, MatchConfig(rk_base=0x01000193), False),
            ("rabin_karp", dense, MatchConfig(verify_capacity=64), True),
            ("boyer_moore", dense, MatchConfig(verify_capacity=64), True),
            ("naive", pat, MatchConfig(pad_multiple=7), False),
            ("naive", dense, MatchConfig(capacity=256), True),
        ]
        for algo, p, cfg, drain in cases:
            r = match(text, p, algo=algo, config=cfg, drain=drain)
            smoke.check(f"7/{algo}/{cfg}", r,
                        want_dense if p == dense else want, n_bytes=len(text))
        mesh = pkg.parallel.mesh.make_data_mesh(1)
        for gather in ("count_sized", "fixed"):
            for algo in ALGOS:
                r = pkg.match_distributed(
                    text, pat, algo=algo, mesh=mesh,
                    config=MatchConfig(dist_gather=gather))
                smoke.check(f"7/distributed/{gather}/{algo}", r, want,
                            n_bytes=len(text))

    smoke.phase("7 every MatchConfig variant at 16 MiB", variants)


def four_cards(smoke: Smoke, pkg, size: int = 1024 * MiB) -> None:
    from conformance.oracle import find_all

    mesh = pkg.parallel.mesh.make_data_mesh(4)
    io = pkg.utils.io
    text = bytearray(io.gen_english(size, seed=2))
    shard = len(text) // 4
    seam_pat = bytes(io.gen_binary(64, seed=9))
    for k in (1, 2, 3):  # straddle each of the three shard seams
        text[k * shard - 32:k * shard + 32] = seam_pat
    text = bytes(text)
    pats = [HEADLINE, b"lazy dog and cat", b"parallel device ",
            b"search algorithm", text[1000:1016], text[shard:shard + 16],
            text[2 * shard - 8:2 * shard + 8], text[-4096:-4080]]

    def run():
        for pat, tag in ((HEADLINE, "m=16"), (seam_pat, "seams/m=64")):
            want = find_all(text, pat)
            for algo in ALGOS:
                r, cold, warm = smoke.timed(
                    lambda: pkg.match_distributed(text, pat, algo=algo,
                                                  mesh=mesh), warm_reps=1)
                smoke.check(f"four/{tag}/{algo}", r, want, cold, warm,
                            len(text), n_devices=4)
        cfg = pkg.MatchConfig(capacity=1 << 18, verify_capacity=1 << 18)
        rs, cold, warm = smoke.timed(
            lambda: pkg.match_distributed(text, pats, algo="rabin_karp",
                                          mesh=mesh, config=cfg),
            warm_reps=1)
        smoke.check("four/rabin_karp_x8", rs,
                    [find_all(text, p) for p in pats], cold, warm,
                    len(text), n_devices=4)

    smoke.phase(f"four cards: match_distributed, {size >> 20} MiB English",
                run)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four", action="store_true",
                    help="run only match_distributed on a 4-card mesh")
    args = ap.parse_args(argv)
    print(card_line(), flush=True)
    # The card-only tests run inside this process; with JAX_PLATFORMS set
    # their conftest leaves the platform alone.
    os.environ.setdefault("JAX_PLATFORMS", "cuda")
    try:
        import jax

        devices = jax.devices()
    except Exception as e:
        print(f"chip_smoke: JAX found no GPU: {e}", file=sys.stderr)
        return 1
    dev = devices[0]
    if dev.platform != "gpu":
        print(f"chip_smoke: needs a GPU, JAX runs on {dev.platform!r}",
              file=sys.stderr)
        return 1
    want = 4 if args.four else 1
    if len(devices) < want:
        print(f"chip_smoke: needs {want} GPUs, found {len(devices)}",
              file=sys.stderr)
        return 1
    try:
        import parallel_implementation_of_string_matching_algorithms_opencl_tpu as pkg  # noqa: E501
        import parallel_implementation_of_string_matching_algorithms_opencl_tpu.parallel.streaming  # noqa: E501,F401
        import conformance.oracle  # noqa: F401
        from parallel_implementation_of_string_matching_algorithms_opencl_tpu.utils.cache import (  # noqa: E501
            enable_compile_cache,
        )
    except ImportError as e:
        print(f"chip_smoke: cannot import tpumatch: {e}", file=sys.stderr)
        return 1
    print(f"device: {dev.platform} / {dev.device_kind} x {len(devices)}; "
          f"compile cache: {enable_compile_cache()}", flush=True)
    smoke = Smoke(jax)
    t0 = time.perf_counter()
    (four_cards if args.four else one_card)(smoke, pkg)
    print(f"total wall: {time.perf_counter() - t0:.1f} s", flush=True)
    if smoke.failures:
        print("FAILED: " + "; ".join(smoke.failures), flush=True)
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind, "count": want}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
