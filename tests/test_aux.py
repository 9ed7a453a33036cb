"""Aux subsystem tests: multihost slicing, profiling helpers, CLI flags,
native-accelerated generators (SURVEY.md §5)."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

from conformance.oracle import find_all
from parallel_implementation_of_string_matching_algorithms_opencl_tpu.parallel import (
    multihost,
)
from parallel_implementation_of_string_matching_algorithms_opencl_tpu.utils import (
    profiling,
)
from parallel_implementation_of_string_matching_algorithms_opencl_tpu.utils.io import (
    gen_english,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# -- multihost slicing ------------------------------------------------------


@pytest.mark.parametrize("size,pc", [(1000, 1), (1000, 3), (1 << 20, 4), (7, 8)])
def test_host_slice_bounds_cover_exactly(size, pc):
    halo = 15
    covered = []
    for pid in range(pc):
        off, owned, read = multihost.host_slice_bounds(size, halo, pid, pc)
        assert 0 <= off <= size
        assert read >= owned >= 0
        assert off + read <= size
        # halo present except at EOF
        if off + owned < size:
            assert read == min(owned + halo, size - off)
        covered.append((off, off + owned))
    # owned ranges tile [0, size) exactly, in order, no gaps/overlap
    covered.sort()
    assert covered[0][0] == 0
    assert covered[-1][1] == size
    for (a0, a1), (b0, b1) in zip(covered, covered[1:]):
        assert a1 == b0


def test_load_host_slice(tmp_path):
    data = gen_english(100_000, seed=9)
    p = tmp_path / "c.bin"
    p.write_bytes(data)
    pieces = []
    for pid in range(4):
        arr, off, owned = multihost.load_host_slice(
            str(p), m=8, process_id=pid, process_count=4
        )
        assert bytes(arr[: owned + 7][:7]) == data[off : off + 7]
        pieces.append(bytes(arr[:owned]))
    assert b"".join(pieces) == data


def test_initialize_cluster_single_process():
    info = multihost.initialize_cluster()
    assert info["process_count"] == 1 and info["process_id"] == 0
    assert info["local_devices"] >= 1


# -- profiling helpers ------------------------------------------------------


def test_timed_and_compiled_stats():
    import jax
    import jax.numpy as jnp

    f = jax.jit(lambda x: (x * 2 + 1).sum())
    x = jnp.arange(1024.0)
    secs, out = profiling.timed(f, x, iters=3)
    assert secs > 0 and float(out) == float((np.arange(1024.0) * 2 + 1).sum())
    stats = profiling.compiled_stats(lambda x: x * 2 + 1, x)
    assert isinstance(stats, dict)


# -- CLI flags --------------------------------------------------------------


def _run_cli(args):
    code = (
        "import jax; jax.config.update('jax_platforms','cpu');"
        "import sys, cli; sys.exit(cli.main(%r))" % (args,)
    )
    return subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True, cwd=REPO
    )


@pytest.fixture(scope="module")
def corpus_file(tmp_path_factory):
    d = tmp_path_factory.mktemp("cli")
    data = gen_english(50_000, seed=31)
    p = d / "c.bin"
    p.write_bytes(data)
    return str(p), data


def test_cli_hex_pattern(corpus_file):
    path, data = corpus_file
    pat = data[100:106]
    out = _run_cli(["bm", path, pat.hex(), "--hex-pattern", "--count-only"])
    assert out.returncode == 0, out.stderr[-1500:]
    assert out.stdout.strip() == str(len(find_all(data, pat)))


def test_cli_multi_pattern_json(corpus_file):
    path, data = corpus_file
    p1, p2 = data[10:20], data[500:510]
    out = _run_cli(["rk", path, p1.decode("latin1"), p2.decode("latin1"), "--json"])
    if out.returncode != 0:  # patterns may not be latin1-roundtrippable
        pytest.skip("corpus slice not utf-8 clean for argv")
    rows = [json.loads(l) for l in out.stdout.strip().splitlines()]
    assert len(rows) == 2


def test_cli_time_flag(corpus_file):
    path, data = corpus_file
    out = _run_cli(["naive", path, "the", "--time", "--count-only"])
    assert out.returncode == 0, out.stderr[-1500:]
    assert "GB/s" in out.stderr


def test_cli_emission_probe_drain_flags(corpus_file):
    path, text = corpus_file
    # dense pattern + tiny capacity: --drain must still print every offset
    out = _run_cli(["bm", path, "e", "--capacity", "256", "--drain",
                    "--offsets", "-1", "--json"])
    assert out.returncode == 0, out.stderr
    import json as _json

    row = _json.loads(out.stdout.strip().splitlines()[-1])
    expected = [i for i in range(len(text)) if text[i:i + 1] == b"e"]
    assert row["count"] == len(expected)
    assert row["offsets"] == expected  # all of them, past capacity


def test_config_rejects_unaligned_pad_multiple():
    import pytest as _pytest

    from parallel_implementation_of_string_matching_algorithms_opencl_tpu.utils.config import (
        MatchConfig,
    )

    for bad in (0, -1, -4):
        with _pytest.raises(ValueError, match="pad_multiple"):
            MatchConfig(pad_multiple=bad)
    MatchConfig(pad_multiple=1)  # any positive value is fine


def test_match_accepts_noncontiguous_uint8_view():
    import numpy as _np

    from parallel_implementation_of_string_matching_algorithms_opencl_tpu import match
    from conformance.oracle import find_all as _find_all

    base = _np.zeros((2048, 2), _np.uint8)
    base[:, 0] = _np.frombuffer(
        b"xy" * 512 + b"NEEDLE" + b"zw" * 509, _np.uint8
    )
    col = base[:, 0]  # non-contiguous view: used to crash on .view(int32)
    expected = _find_all(col.tobytes(), b"NEEDLE")
    r = match(col, b"NEEDLE", algo="naive")
    assert r.count == len(expected) and r.offsets_list() == expected


def test_valid_prefix_trims_at_first_hole():
    import numpy as _np

    from parallel_implementation_of_string_matching_algorithms_opencl_tpu.models.base import (
        valid_prefix,
    )

    o = _np.array([3, 7, -1, 12, 15], _np.int64)
    assert valid_prefix(o).tolist() == [3, 7]
    o2 = _np.array([3, 7, 9], _np.int64)
    assert valid_prefix(o2).tolist() == [3, 7, 9]
    assert valid_prefix(_np.array([], _np.int64)).tolist() == []
