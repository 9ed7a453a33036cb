"""Multi-host bootstrap (SURVEY.md §2.3, §3.3 — config 5, BASELINE.json:11).

The reference is a single-process OpenCL program; multi-host scale-out is a
target-framework feature.  The communication backend is the XLA collective
layer (NCCL between cards, the network between hosts) — no custom
transport: this module only
bootstraps the process group (``jax.distributed.initialize``) and provides
per-host corpus slicing with overlapping halo *file reads*, so halo exchange
at host granularity needs no network traffic at all (each host simply reads
m-1 bytes past its slice).  Chip-granularity halos inside a host's shards
still travel between devices via ppermute (parallel/dist.py).
"""

from __future__ import annotations

import os

import numpy as np

# jax.distributed.initialize must run BEFORE any XLA backend is touched
# (jax.process_count()/jax.devices() initialize backends), so repeat-call
# guarding uses this module flag, never a backend query (round-1 advisor).
_initialized = False


def initialize_cluster(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
) -> dict:
    """Initialize the JAX process group (idempotent).

    Topology is decided from the arguments / environment ALONE
    (TPUMATCH_NUM_PROCESSES etc.) — backend state is only queried after
    ``jax.distributed.initialize`` has run.  With no arguments and no env,
    the process stays single-process.  Returns topology facts.
    """
    global _initialized
    import jax

    if num_processes is None:
        env_np = os.environ.get("TPUMATCH_NUM_PROCESSES")
        num_processes = int(env_np) if env_np else None
    if coordinator_address is None:
        coordinator_address = os.environ.get("TPUMATCH_COORDINATOR") or None
    if process_id is None:
        env_pid = os.environ.get("TPUMATCH_PROCESS_ID")
        process_id = int(env_pid) if env_pid is not None else None
    if num_processes is None and (
        coordinator_address is not None or process_id is not None
    ):
        # A coordinator/process_id without num_processes would silently
        # stay single-process and return per-host partial results as if
        # they were global — make the misconfiguration loud instead.
        raise ValueError(
            "initialize_cluster: coordinator_address/process_id given "
            "without num_processes (set it or TPUMATCH_NUM_PROCESSES)"
        )
    if not _initialized and (num_processes or 1) > 1:
        jax.distributed.initialize(
            coordinator_address=coordinator_address,
            num_processes=num_processes,
            process_id=process_id,
        )
        _initialized = True
    return {
        "process_id": jax.process_index(),
        "process_count": jax.process_count(),
        "local_devices": len(jax.local_devices()),
        "global_devices": len(jax.devices()),
    }


def host_slice_bounds(
    file_size: int, halo: int, process_id: int, process_count: int,
    align: int = 1,
) -> tuple[int, int, int]:
    """(offset, owned_len, read_len) for this host's corpus slice.

    The file is split evenly (aligned down to ``align``); each host reads
    ``halo`` extra bytes past its owned range (overlapping read — the
    host-level halo needs no communication).  The last host absorbs the
    remainder.
    """
    base = file_size // process_count
    if align > 1:
        base = (base // align) * align
    offset = process_id * base
    owned = base if process_id < process_count - 1 else file_size - offset
    read = min(owned + halo, file_size - offset)
    return offset, owned, read


def load_host_slice(path: str, m: int, process_id: int | None = None,
                    process_count: int | None = None):
    """mmap-read this host's slice (+ (m-1)-byte halo) of a shared corpus.

    Returns (uint8 array of read_len bytes, global_offset, owned_len).
    Matches starting in [global_offset, global_offset+owned_len) are this
    host's; the tail halo is lookahead only (SURVEY.md §3.3).
    """
    import jax

    pid = jax.process_index() if process_id is None else process_id
    pc = jax.process_count() if process_count is None else process_count
    size = os.path.getsize(path)
    offset, owned, read = host_slice_bounds(size, m - 1, pid, pc)
    mm = np.memmap(path, dtype=np.uint8, mode="r")
    arr = np.asarray(mm[offset : offset + read])
    return arr, offset, owned


def _allgather_i64_exact(arr: "np.ndarray", pc: int) -> "np.ndarray":
    """process_allgather of an int64 array WITHOUT the silent int64->int32
    truncation jax applies when x64 mode is off (default): ship hi/lo
    int32 planes and reassemble.  Offsets past 2 GiB — i.e. any corpus at
    config-5 scale — would otherwise wrap negative.  Returns (pc, *shape)
    int64."""
    from jax.experimental import multihost_utils

    arr = np.asarray(arr, np.int64)
    lo = (arr & 0xFFFFFFFF).astype(np.uint32).view(np.int32)
    hi = (arr >> 32).astype(np.int32)
    both = np.stack([lo, hi])  # int32[2, ...]
    g = np.asarray(
        multihost_utils.process_allgather(both, tiled=False)
    ).reshape((pc,) + both.shape)
    glo = g[:, 0].astype(np.int64) & 0xFFFFFFFF
    ghi = g[:, 1].astype(np.int64)
    return (ghi << 32) | glo


def _allgather_ragged_i64(local: "np.ndarray", pc: int) -> "np.ndarray":
    """Two-phase count-sized all-gather of ragged int64 rows over DCN.

    Phase 1 gathers only the per-host lengths; phase 2 gathers buffers
    padded to the MAX length — not a fixed worst-case capacity — so DCN
    traffic scales with the actual result size (BASELINE.json:5 >=90%
    scaling target; the device-mesh analogue lives in parallel/dist.py).
    Rows concatenate in process order; with hosts owning ascending file
    ranges and per-host rows sorted, the result is globally sorted.
    """
    local = np.asarray(local, np.int64)
    lens = _allgather_i64_exact(
        np.array([len(local)], np.int64), pc
    ).reshape(pc)
    mx = int(lens.max())
    if mx == 0:
        return np.empty(0, np.int64)
    buf = np.full(mx, -1, np.int64)
    buf[: len(local)] = local
    rows = _allgather_i64_exact(buf, pc).reshape(pc, mx)
    return np.concatenate([rows[p, : lens[p]] for p in range(pc)])


def match_multihost_streaming(
    path: str,
    pattern,
    algo="boyer_moore",
    config=None,
    chunk_bytes: int | None = None,
    manifest_path: str | None = None,
    resume: bool = False,
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    gather_offsets: bool = True,
    drain: bool = False,
):
    """Config 5 at its STATED scale: stream a huge shared corpus across
    N>=2 hosts (BASELINE.json:11 — "all four algorithms on a 100GB sharded
    corpus across N>=2 hosts with psum count reduction and offset
    all-gather").

    Composition of the two halves that round 3 left separate: each host
    streams ITS owned slice of the file in fixed chunks
    (``StreamingMatcher.match_file(start, stop)`` — so per-host HBM use is
    one chunk, not size/N), gets its host-level halo from the overlapping
    file read (zero network traffic), journals its own offsets, and the
    final merge is ONE collective round: an all-gather of per-slot
    (count, overflow) plus a count-sized two-phase offset gather
    (``_allgather_ragged_i64``).  Resume is per-host: each host keeps its
    own manifest + journals (``manifest_path + ".h<pid>"``) and restarts
    from its own last completed chunk.

    ``pattern``/``algo`` accept the same forms as ``StreamingMatcher``
    (one pattern + list of algorithms, or list of patterns + one
    algorithm).  ``gather_offsets=False`` skips the offset collective —
    counts/overflows are still global, offsets are THIS host's journal
    slice only (``res.algo`` gains a ``!local-offsets`` marker) — for
    match-dense corpora where replicating every offset to every host is
    the wrong call.  ``drain=True`` re-extracts each host's overflowing
    chunks (``StreamingMatcher.match_file(drain=True)``), so the gathered
    offsets are complete past per-chunk capacity and the global overflow
    flag stays False.

    Every process must call this collectively; all return identical
    global counts (and offsets when gathered).
    """
    from ..models.base import MatchResult
    from ..utils.config import DEFAULT_CONFIG
    from .streaming import DEFAULT_CHUNK_BYTES, StreamingMatcher

    cfg = config or DEFAULT_CONFIG
    info = initialize_cluster(coordinator_address, num_processes, process_id)
    pid, pc = info["process_id"], info["process_count"]
    size = os.path.getsize(path)

    if isinstance(pattern, str):
        pattern = pattern.encode("utf-8")
    sm = StreamingMatcher(
        pattern,
        algo=algo,
        config=cfg,
        chunk_bytes=chunk_bytes or DEFAULT_CHUNK_BYTES,
        manifest_path=(manifest_path + f".h{pid}") if manifest_path else None,
    )
    # Split ownership chunk-aligned so every interior chunk is full-sized
    # (one compiled executable serves all chunks on all hosts); the last
    # host absorbs the remainder.  halo=0: the streaming iterator already
    # reads (max_m - 1) past each chunk's owned end, including past the
    # slice boundary.
    offset, owned, _read = host_slice_bounds(
        size, 0, pid, pc, align=sm.chunk_bytes
    )
    local = sm.match_file(path, resume=resume, start=offset,
                          stop=offset + owned, drain=drain)
    single = not isinstance(local, list)
    locals_ = [local] if single else local

    if pc == 1:
        return local

    k = len(locals_)
    stats = _allgather_i64_exact(
        np.array([[r.count, int(r.overflow)] for r in locals_], np.int64),
        pc,
    ).reshape(pc, k, 2)
    results = []
    for i, r in enumerate(locals_):
        offs = r.offsets.astype(np.int64)
        offs = offs[offs >= 0]
        tag = f"@stream-hosts{pc}"
        if gather_offsets:
            offs = _allgather_ragged_i64(offs, pc)
        else:
            tag += "!local-offsets"
        results.append(
            MatchResult(
                algo=r.algo.split("@")[0] + tag,
                pattern=r.pattern,
                n=size,
                count=int(stats[:, i, 0].sum()),
                offsets=offs,
                overflow=bool(stats[:, i, 1].any()),
            )
        )
    return results[0] if single else results


def match_multihost(
    path: str,
    pattern,
    algo: str = "boyer_moore",
    config=None,
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    drain: bool = False,
):
    """End-to-end multi-host match over a shared corpus file (SURVEY.md
    §3.3, BASELINE.json:11 config 5).

    Per host: mmap-read my slice plus an (m-1)-byte tail halo (overlapping
    file reads — the host-level halo costs zero network traffic), scan it
    with the local matcher, and rebase offsets by the slice's global file
    offset.  Ownership needs no extra masking: an interior host reads
    exactly owned+(m-1) bytes, so the matcher's own validity limit
    p <= read-m equals "p starts in my owned range" (the same identity the
    streaming driver uses).  Global merge: one ``process_allgather`` of
    (count, overflow) and of the fixed-capacity offset buffers — the
    multi-process form of the psum/all-gather merge in parallel/dist.py.

    ``drain=True`` runs the local scan as ``match_all`` (windowed
    re-extraction per host slice), so the gathered offsets are COMPLETE
    even past per-host capacity.  Either way the offset gather is the
    count-sized two-phase form (``_allgather_ragged_i64``) — DCN traffic
    scales with the result, not with capacity.

    Every process must call this collectively; all return the identical
    global MatchResult.
    """
    import jax

    from ..models.base import MatchResult, valid_prefix
    from ..models.registry import get_matcher
    from ..utils.config import DEFAULT_CONFIG

    if isinstance(pattern, str):
        pattern = pattern.encode("utf-8")
    pattern = bytes(pattern)
    cfg = config or DEFAULT_CONFIG
    info = initialize_cluster(coordinator_address, num_processes, process_id)
    pid, pc = info["process_id"], info["process_count"]
    size = os.path.getsize(path)
    arr, offset, owned = load_host_slice(path, len(pattern), pid, pc)
    matcher = get_matcher(algo)(pattern, cfg)
    local = matcher.match_all(arr) if drain else matcher.match(arr)
    # Trim at the first FILL(-1) hole BEFORE rebasing (the screened sparse
    # paths can leave interior -1 entries when candidate blocks exceed the
    # gather tier, and entries past a hole may be preceded by missed
    # matches) — rebasing first would turn fills into phantom offset-1
    # hits.
    local_offs = valid_prefix(
        np.asarray(local.offsets, np.int64)
    ) + offset

    if pc == 1:
        return MatchResult(
            algo=f"{algo}@hosts1", pattern=pattern, n=size,
            count=local.count, offsets=local_offs,
            overflow=local.overflow,
        )

    stats = _allgather_i64_exact(
        np.array([local.count, int(local.overflow)], np.int64), pc
    ).reshape(pc, 2)
    offs = _allgather_ragged_i64(local_offs, pc)
    return MatchResult(
        algo=f"{algo}@hosts{pc}",
        pattern=pattern,
        n=size,
        count=int(stats[:, 0].sum()),
        offsets=offs,
        overflow=bool(stats[:, 1].any()),
    )
