#!/usr/bin/env python
"""Command-line interface (SURVEY.md §1.2 "API / CLI / bench").

The reference's surface is ``./<algo> <textfile> <pattern>`` per-algorithm
host binaries (SURVEY.md R5); ours is one CLI over the library:

    python cli.py <algo> <textfile> <pattern> [options]

Algorithms: naive, rabin_karp (rk), kmp, boyer_moore (bm).
Execution modes: single device (default), --distributed (mesh-sharded with
halo overlap), --stream (chunked unbounded-size scan with resume manifest).
"""

from __future__ import annotations

import argparse
import json
import sys
import time


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="tpumatch",
        description="Exact string matching on a GPU with JAX (naive/RK/KMP/BM)",
    )
    ap.add_argument("algo", help="naive | rabin_karp | kmp | boyer_moore (+aliases rk, bm)")
    ap.add_argument("textfile", help="path to the text corpus")
    ap.add_argument("pattern", nargs="+", help="pattern(s); multiple → multi-pattern run")
    ap.add_argument("--distributed", action="store_true", help="shard over the device mesh")
    ap.add_argument("--stream", action="store_true", help="stream file in chunks (unbounded size)")
    ap.add_argument("--chunk-mb", type=int, default=64, help="streaming chunk size (MiB)")
    ap.add_argument("--manifest", default=None, help="streaming resume manifest path")
    ap.add_argument("--resume", action="store_true", help="resume a streaming run from --manifest")
    ap.add_argument("--capacity", type=int, default=65536, help="offset buffer capacity")
    ap.add_argument("--count-only", action="store_true", help="print only the match count")
    ap.add_argument("--json", action="store_true", help="emit a JSON result object")
    ap.add_argument("--offsets", type=int, default=20, metavar="K", help="print first K offsets (default 20; -1 = all)")
    ap.add_argument("--hex-pattern", action="store_true", help="interpret pattern args as hex byte strings")
    ap.add_argument("--time", action="store_true", help="print wall time and bytes/s to stderr")
    ap.add_argument("--drain", action="store_true",
                    help="guarantee ALL offsets even past --capacity "
                         "(windowed re-extraction; all modes incl. "
                         "--stream, where overflowing chunks are re-read "
                         "and re-extracted)")
    ap.add_argument("--multihost", action="store_true",
                    help="run collectively across the JAX process group "
                         "(topology from TPUMATCH_COORDINATOR / "
                         "TPUMATCH_NUM_PROCESSES / TPUMATCH_PROCESS_ID); "
                         "combine with --stream for per-host chunked "
                         "streaming (config 5 scale)")
    return ap


def main(argv=None) -> int:
    ap = build_parser()
    args = ap.parse_args(argv)

    from parallel_implementation_of_string_matching_algorithms_opencl_tpu.utils.cache import (
        enable_compile_cache,
    )

    enable_compile_cache()

    from parallel_implementation_of_string_matching_algorithms_opencl_tpu import (
        match,
        match_distributed,
    )
    from parallel_implementation_of_string_matching_algorithms_opencl_tpu.parallel.streaming import (
        match_stream,
    )
    from parallel_implementation_of_string_matching_algorithms_opencl_tpu.utils.io import (
        load_file,
    )

    if args.hex_pattern:
        patterns = [bytes.fromhex(p) for p in args.pattern]
    else:
        patterns = [p.encode("utf-8") for p in args.pattern]

    overrides = {"capacity": args.capacity}

    t0 = time.perf_counter()
    if args.stream and args.multihost:
        from parallel_implementation_of_string_matching_algorithms_opencl_tpu.parallel.multihost import (
            match_multihost_streaming,
        )

        from parallel_implementation_of_string_matching_algorithms_opencl_tpu.utils.config import (
            DEFAULT_CONFIG,
        )

        out = match_multihost_streaming(
            args.textfile,
            patterns if len(patterns) > 1 else patterns[0],
            algo=args.algo,
            config=DEFAULT_CONFIG.replace(**overrides),
            chunk_bytes=args.chunk_mb << 20,
            manifest_path=args.manifest,
            resume=args.resume,
            drain=args.drain,
        )
        results = out if isinstance(out, list) else [out]
    elif args.stream:
        from parallel_implementation_of_string_matching_algorithms_opencl_tpu.utils.config import (
            DEFAULT_CONFIG,
        )

        out = match_stream(
            args.textfile,
            patterns if len(patterns) > 1 else patterns[0],
            algo=args.algo,
            config=DEFAULT_CONFIG.replace(**overrides),
            chunk_bytes=args.chunk_mb << 20,
            manifest_path=args.manifest,
            resume=args.resume,
            drain=args.drain,
        )
        results = out if isinstance(out, list) else [out]
    elif args.multihost:
        from parallel_implementation_of_string_matching_algorithms_opencl_tpu.parallel.multihost import (
            match_multihost,
        )

        out = match_multihost(args.textfile, patterns[0], algo=args.algo,
                              drain=args.drain)
        results = [out]
    else:
        text = load_file(args.textfile)
        if args.distributed:
            out = match_distributed(
                text,
                patterns if len(patterns) > 1 else patterns[0],
                algo=args.algo,
                drain=args.drain,
                **overrides,
            )
            results = out if isinstance(out, list) else [out]
        else:
            out = match(
                text,
                patterns if len(patterns) > 1 else patterns[0],
                algo=args.algo,
                drain=args.drain,
                **overrides,
            )
            results = out if isinstance(out, list) else [out]
    wall = time.perf_counter() - t0

    if args.time:
        nbytes = results[0].n * len(results)
        print(
            f"{wall:.3f}s  {nbytes / wall / 1e9:.2f} GB/s", file=sys.stderr
        )

    for pat, r in zip(patterns, results):
        if args.json:
            k = len(r.offsets) if args.offsets < 0 else min(args.offsets, len(r.offsets))
            print(
                json.dumps(
                    {
                        "algo": r.algo,
                        "pattern": pat.decode("utf-8", "replace"),
                        "n_bytes": r.n,
                        "count": r.count,
                        "overflow": r.overflow,
                        "offsets": [int(x) for x in r.offsets[:k]],
                        "wall_s": wall,
                    }
                )
            )
        elif args.count_only:
            print(r.count)
        else:
            show = r.offsets if args.offsets < 0 else r.offsets[: args.offsets]
            tail = "" if len(show) == r.count else f" ... (+{r.count - len(show)} more)"
            print(
                f"{r.algo}: pattern {pat!r}: {r.count} match(es)"
                + (f" at {[int(x) for x in show]}{tail}" if r.count else "")
            )
    return 0


if __name__ == "__main__":
    sys.exit(main())
