#!/usr/bin/env python
"""Benchmark harness: bytes/s per algorithm on one GPU (BASELINE.json:2).

    python bench.py [--mb 256] [--algos naive,rabin_karp,kmp,boyer_moore]

Prints ONE final JSON line to stdout:
    {"metric": "...", "value": N, "unit": "bytes/s/chip", "vs_baseline": N,
     "device": "...", "hbm_roofline_share": N}

Each algorithm's jitted runner is timed on a device-resident text: wall
clock around calls that end in ``block_until_ready``, best and median of
``--iters``.  ``vs_baseline`` is the ratio against the 10 GB/s/chip target
of BASELINE.json:5; ``hbm_roofline_share`` is the least time one read of
the text could take at the card's published memory rate (``PEAKS``) over
the measured wall.  Per-algorithm detail rows go to stderr and to
``--detail-out``.  The run fails on a device that is not a GPU, and on a
GPU that ``PEAKS`` does not list.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import time

import numpy as np

# Published peaks per device kind (jax.devices()[0].device_kind).
PEAKS = {
    "NVIDIA H100 80GB HBM3": {
        "hbm_bytes_per_s": 3.35e12,
        "source": "NVIDIA H100 SXM5 data sheet (80 GB HBM3)",
    },
}


def peak(device_kind: str) -> dict:
    """The ``PEAKS`` row for ``device_kind``; an unknown device is an
    error, never a default."""
    try:
        return PEAKS[device_kind]
    except KeyError:
        raise ValueError(
            f"no published peaks for device kind {device_kind!r}; add it "
            f"to bench.PEAKS with its source"
        ) from None


def bench_algo(algo: str, text_np, n: int, pattern: bytes, iters: int, cfg):
    import jax
    import jax.numpy as jnp

    from parallel_implementation_of_string_matching_algorithms_opencl_tpu.models.registry import (
        get_matcher,
    )

    matcher = get_matcher(algo)(pattern, cfg)
    runner = matcher._runner(matcher.config)
    args = (
        jax.device_put(text_np),
        jnp.int32(n),
        jax.device_put(matcher.pattern_arr),
        jax.tree.map(jax.device_put, matcher.tables),
    )
    jax.block_until_ready(args)
    t0 = time.perf_counter()
    out = jax.block_until_ready(runner(*args))
    compile_s = time.perf_counter() - t0
    walls = []
    for _ in range(iters):
        t0 = time.perf_counter()
        out = jax.block_until_ready(runner(*args))
        walls.append(time.perf_counter() - t0)
    best = min(walls)
    return {
        "algo": algo,
        "n_bytes": n,
        "wall_s": best,
        "wall_median_s": statistics.median(walls),
        "bytes_per_s_per_chip": n / best,
        "first_call_s": compile_s,
        "match_count": int(out[0]),
        "iters": iters,
    }


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--mb", type=int, default=256, help="corpus size in MiB")
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--algos", default="naive,rabin_karp,kmp,boyer_moore")
    ap.add_argument("--corpus", default="english")
    ap.add_argument("--pattern", default="quick brown fox ")
    ap.add_argument("--headline", default="boyer_moore")
    ap.add_argument("--detail-out", default="BENCH_DETAIL.json")
    args = ap.parse_args()

    import jax

    from parallel_implementation_of_string_matching_algorithms_opencl_tpu.utils.cache import (
        enable_compile_cache,
    )
    from parallel_implementation_of_string_matching_algorithms_opencl_tpu.utils.config import (
        MatchConfig,
    )
    from parallel_implementation_of_string_matching_algorithms_opencl_tpu.utils.io import (
        GENERATORS,
        pad_to_multiple,
    )

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        sys.exit(f"bench.py measures a GPU; JAX runs on {dev.platform!r}")
    hbm = peak(dev.device_kind)["hbm_bytes_per_s"]
    enable_compile_cache()
    device = f"{dev.platform}/{dev.device_kind}"
    print(f"device: {device}", file=sys.stderr)

    n = args.mb * (1 << 20)
    text = GENERATORS[args.corpus](n, seed=42)
    cfg = MatchConfig()
    text_np = pad_to_multiple(np.frombuffer(text, dtype=np.uint8),
                              cfg.pad_multiple)
    pattern = args.pattern.encode()

    results = {}
    for algo in args.algos.split(","):
        r = bench_algo(algo, text_np, n, pattern, args.iters, cfg)
        r["hbm_roofline_share"] = (n / hbm) / r["wall_s"]
        results[algo] = r
        print(
            f"  {algo:12s} {r['bytes_per_s_per_chip'] / 1e9:8.2f} GB/s  "
            f"({r['wall_s'] * 1e3:.2f} ms best of {args.iters}, median "
            f"{r['wall_median_s'] * 1e3:.2f} ms, count={r['match_count']}, "
            f"first call {r['first_call_s']:.1f}s)",
            file=sys.stderr,
        )
    with open(args.detail_out, "w") as f:
        json.dump({"device": device, "results": results}, f, indent=2)
        f.write("\n")

    TARGET = 10e9  # BM >= 10 GB/s/chip, BASELINE.json:5
    head = results.get(args.headline) or results[args.algos.split(",")[-1]]
    print(json.dumps({
        "metric": f"{args.headline} bytes/s/chip ({args.corpus} "
                  f"{args.mb}MiB, m={len(pattern)})",
        "value": round(head["bytes_per_s_per_chip"], 1),
        "unit": "bytes/s/chip",
        "vs_baseline": round(head["bytes_per_s_per_chip"] / TARGET, 4),
        "device": device,
        "hbm_roofline_share": round(head["hbm_roofline_share"], 4),
    }))


if __name__ == "__main__":
    main()
