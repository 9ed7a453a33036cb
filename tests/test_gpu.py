"""Card-only checks: the plain scans as XLA compiles them for a GPU, against
the oracle.  Marked ``gpu``; each skips where JAX has no GPU (the ``gpu``
fixture decides at run time).  On the card: ``python chip_smoke.py`` runs
them in its phase 6, or ``JAX_PLATFORMS=cuda python -m pytest -m gpu tests/``.
"""

import numpy as np
import pytest

from conformance.oracle import find_all
from parallel_implementation_of_string_matching_algorithms_opencl_tpu import (
    match,
    match_distributed,
)
from parallel_implementation_of_string_matching_algorithms_opencl_tpu.models import (
    backend,
)
from parallel_implementation_of_string_matching_algorithms_opencl_tpu.parallel.mesh import (
    make_data_mesh,
)
from parallel_implementation_of_string_matching_algorithms_opencl_tpu.utils.config import (
    MatchConfig,
)
from parallel_implementation_of_string_matching_algorithms_opencl_tpu.utils.io import (
    GENERATORS,
)

ALGOS = ["naive", "rabin_karp", "kmp", "boyer_moore"]
N = 1 << 20


def _text(corpus: str) -> bytes:
    return GENERATORS[corpus](N, seed=11)[:N]


@pytest.mark.gpu
def test_backend_is_the_gpu(gpu):
    import jax

    assert jax.default_backend() == "gpu"
    assert backend.execution_path() == backend.PLAIN


@pytest.mark.gpu
@pytest.mark.parametrize("corpus", ["english", "dna", "utf8"])
@pytest.mark.parametrize("m", [1, 16, 256])
@pytest.mark.parametrize("algo", ALGOS)
def test_match_on_the_gpu(gpu, algo, m, corpus):
    text = _text(corpus)
    pat = text[N // 3:N // 3 + m]
    want = find_all(text, pat)
    r = match(text, pat, algo=algo, drain=True)
    assert r.count == len(want)
    assert r.offsets_list() == want


@pytest.mark.gpu
@pytest.mark.parametrize("kmp_chunk", [64, 256, 2048])
def test_kmp_chunks_on_the_gpu(gpu, kmp_chunk):
    text = _text("english")
    pat = b"quick brown fox "
    r = match(text, pat, algo="kmp", config=MatchConfig(kmp_chunk=kmp_chunk))
    assert r.offsets_list() == find_all(text, pat)


@pytest.mark.gpu
def test_multi_pattern_on_the_gpu(gpu):
    text = _text("english")
    rng = np.random.default_rng(3)
    pats = [text[p:p + 16] for p in rng.integers(0, N - 16, size=8)]
    rs = match(text, pats, algo="rabin_karp")
    assert [r.offsets_list() for r in rs] == [find_all(text, p) for p in pats]


@pytest.mark.gpu
@pytest.mark.parametrize("algo", ALGOS)
def test_distributed_on_one_gpu(gpu, algo):
    text = _text("english")
    pat = text[1000:1016]
    r = match_distributed(text, pat, algo=algo, mesh=make_data_mesh(1))
    assert r.offsets_list() == find_all(text, pat)
