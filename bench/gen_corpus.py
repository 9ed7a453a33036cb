#!/usr/bin/env python
"""Generate the config-5 100 GB planted corpus to .corpora/ (resumable by
segment: re-running skips a completed file).  Used by bench/stream100.py."""
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from matrix import _gen_corpus_file  # noqa: E402

TOTAL = int(float(sys.argv[1])) if len(sys.argv) > 1 else 100_000_000_000
# One corpus file per size (a 10 GB proxy and the full 100 GB coexist).
PATH = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    ".corpora", f"c5_{TOTAL // 1_000_000_000}gb.bin",
)
PAT = b"shard merge psum"


def main():
    os.makedirs(os.path.dirname(PATH), exist_ok=True)
    if os.path.exists(PATH) and os.path.getsize(PATH) == TOTAL and \
            os.path.exists(PATH + ".meta.json"):
        print("already generated")
        return
    t0 = time.time()
    planted = _gen_corpus_file(PATH, TOTAL, PAT, seed=5, plant_every=1 << 29)
    with open(PATH + ".meta.json", "w") as f:
        json.dump({"planted": planted, "pattern": PAT.decode(), "seed": 5,
                   "total": TOTAL}, f)
    print(f"done in {time.time() - t0:.0f}s, {len(planted)} plants")


if __name__ == "__main__":
    main()
