#!/usr/bin/env python
"""Config-5 at stated SHAPE across real processes: N local processes each
stream their owned slice of a >=10 GB planted corpus (round-4 VERDICT next
#1's bench criterion) through ``match_multihost_streaming`` — per-host
chunked streaming, host-level halo from overlapping file reads, one
count-sized two-phase collective merge round at the end.

A CPU-only rehearsal: several JAX processes on one card would each reserve
most of its memory, so the workers run on the CPU backend and the BYTES/S
HERE ARE CODE-PATH VALIDATION, NOT DEVICE PERFORMANCE — the row carries
mode='cpu-2proc-codepath' accordingly, like the BENCH_SCALING rows.  Exactness is absolute: every planted offset must
be present and counts must agree across processes.

Usage: python bench/stream_multihost.py [--path .corpora/c5_10gb.bin]
           [--procs 2] [--chunk-mb 256] [--algo boyer_moore]
"""

from __future__ import annotations

import argparse
import json
import os as _os
import socket
import subprocess
import sys as _sys
import tempfile
import time

_sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))))

ROOT = _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__)))

WORKER_SRC = r'''
import json, os, sys, time
os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                           + " --xla_force_host_platform_device_count=2").strip()
import jax
jax.config.update("jax_platforms", "cpu")
sys.path.insert(0, os.environ["TPUMATCH_ROOT"])
from parallel_implementation_of_string_matching_algorithms_opencl_tpu.parallel import multihost

pid, nprocs, port = int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3])
path, pattern_hex, algo, chunk, out_path = (
    sys.argv[4], sys.argv[5], sys.argv[6], int(sys.argv[7]), sys.argv[8])
t0 = time.perf_counter()
res = multihost.match_multihost_streaming(
    path, bytes.fromhex(pattern_hex), algo=algo, chunk_bytes=chunk,
    manifest_path=out_path + ".manifest",
    coordinator_address="localhost:%d" % port,
    num_processes=nprocs, process_id=pid,
)
wall = time.perf_counter() - t0
with open(out_path, "w") as f:
    json.dump({"count": res.count, "offsets": res.offsets_list(),
               "overflow": res.overflow, "wall_s": wall,
               "algo": res.algo}, f)
'''


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--path", default=_os.path.join(
        ROOT, ".corpora", "c5_10gb.bin"))
    ap.add_argument("--procs", type=int, default=2)
    ap.add_argument("--chunk-mb", type=int, default=256)
    ap.add_argument("--algo", default="boyer_moore")
    args = ap.parse_args()

    meta = json.load(open(args.path + ".meta.json"))
    pat = meta["pattern"].encode()
    planted = meta["planted"]
    size = _os.path.getsize(args.path)
    assert size == meta["total"], (size, meta["total"])

    tmp = tempfile.gettempdir()
    worker = _os.path.join(tmp, "tpumatch_smh_worker.py")
    with open(worker, "w") as f:
        f.write(WORKER_SRC)
    port = _free_port()
    outs = [_os.path.join(tmp, f"tpumatch_smh_{p}.json")
            for p in range(args.procs)]
    for o in outs:
        for suff in ("", ".manifest"):
            try:
                _os.unlink(o + suff)
            except OSError:
                pass
    env = dict(_os.environ)
    env["TPUMATCH_ROOT"] = ROOT
    t0 = time.perf_counter()
    procs = [
        subprocess.Popen(
            [_sys.executable, worker, str(p), str(args.procs), str(port),
             args.path, pat.hex(), args.algo,
             str(args.chunk_mb << 20), outs[p]],
            env=env,
        )
        for p in range(args.procs)
    ]
    for p in procs:
        rc = p.wait()
        assert rc == 0, f"worker rc={rc}"
    wall = time.perf_counter() - t0

    results = [json.load(open(o)) for o in outs]
    base = results[0]
    ok = all(
        r["count"] == base["count"] and r["offsets"] == base["offsets"]
        and not r["overflow"] for r in results
    )
    ok &= set(planted).issubset(set(base["offsets"]))
    row = {
        "config": 5,
        "algo": f"{args.algo}_stream_multihost",
        "n_bytes": size,
        "n_procs": args.procs,
        "chunk_bytes": args.chunk_mb << 20,
        "wall_s": wall,
        "bytes_per_s": size / wall,
        "match_count": base["count"],
        "exact_parity": bool(ok),
        "parity_mode": "planted-subset+cross-process",
        "mode": "cpu-2proc-codepath",
    }
    print(json.dumps(row), flush=True)
    with open(_os.path.join(ROOT, "BENCH_MATRIX.json"), "a") as f:
        f.write(json.dumps(row) + "\n")
    assert ok, "2-process streaming parity FAILED"
    print(f"PASS: {size/1e9:.0f} GB x {args.procs} procs in {wall:.0f}s, "
          f"count={base['count']}", file=_sys.stderr)


if __name__ == "__main__":
    main()
