"""The port's ``StreamingSearcher`` on its CPU path against the JAX
package's (K1 interpreted on the CPU) and the port's resident
``SearchEngine``: the mirror of every single-device test of
``tests/test_streaming.py``, plus twins split across chunks, a filter that
empties a chunk, a chunk size off the row multiple and the other dtypes.

Against the port's resident engine the indices and ids are identical, and
so are the scores wherever the dots are exact in f32 (integer data and
codes): the chunked scan and the stable merge give K1's answer. On float
data the plain version's matmul sums a row in an order that depends on the
block's shape (the CPU's BLAS), so there the scores agree within 1e-5, the
band of ``tests/test_streaming.py``; on the card K1 sums a row in one order
whatever the chunk (``chip_smoke.py`` phase 18 holds it bit for bit).
Against the JAX package the indices are identical and the scores within
1e-5, identical on integer data."""

import numpy as np
import pytest
import torch

from metrovector_tpu import Builder, DataType, DistanceMetric, Reader
from metrovector_tpu.ops import numpy_oracle
from metrovector_tpu.parallel import StreamingSearcher as JaxStreaming
from metrovector_tpu_torch import Reader as PortReader
from metrovector_tpu_torch import SearchEngine, StreamingSearcher
from metrovector_tpu_torch.parallel.streaming import merge_topk


def _open(path, name="v"):
    return PortReader.open(path).vector_space(name)


def _jax_space(path, name="v"):
    return Reader.open(path).vector_space(name)


def _same(a, b, exact=True):
    """Identical results; ``exact=False`` (float data on the CPU): the
    scores within the f32 band (an L2 distance near 0 is the square root of
    a cancellation, so the scores are what is compared)."""
    np.testing.assert_array_equal(a.indices, b.indices)
    np.testing.assert_array_equal(a.ids, b.ids)
    if exact:
        np.testing.assert_array_equal(a.scores, b.scores)
        np.testing.assert_array_equal(a.distances, b.distances)
    else:
        np.testing.assert_allclose(a.scores, b.scores, rtol=1e-5, atol=1e-5)


def _resident(path, name="v"):
    return SearchEngine(_open(path, name), device="cpu")


@pytest.fixture
def big_space(tmp_path, rng):
    data = rng.standard_normal((2000, 32)).astype(np.float32)
    b = Builder()
    b.add_vector_space("v", dim=32)
    b.add_vectors("v", data)
    b.delete_vector("v", 1234)
    path = tmp_path / "big.mvt"
    b.build().save(path)
    return path, data


@pytest.mark.parametrize("chunk_rows", [256, 512, 1000])
def test_streaming_matches_resident(big_space, rng, chunk_rows):
    path, _ = big_space
    queries = rng.standard_normal((4, 32)).astype(np.float32)
    got = StreamingSearcher(_open(path), chunk_rows=chunk_rows, device="cpu").search(
        queries, k=12)
    _same(got, _resident(path).search(queries, k=12), exact=False)
    ref = JaxStreaming(_jax_space(path), chunk_rows=chunk_rows).search(queries, k=12)
    np.testing.assert_array_equal(got.indices, ref.indices)
    np.testing.assert_allclose(got.scores, ref.scores, rtol=1e-5, atol=1e-5)


def test_streaming_oracle_parity_with_tombstone(big_space):
    path, data = big_space
    queries = data[[1234, 7]]  # the deleted row queried directly
    res = StreamingSearcher(_open(path), chunk_rows=512, device="cpu").search(queries, k=5)
    assert 1234 not in res.indices
    mask = np.ones(2000, np.float32)
    mask[1234] = 0
    _, oi = numpy_oracle(queries, data, 5, DistanceMetric.L2, valid_mask=mask)
    np.testing.assert_array_equal(res.indices, oi)
    ref = JaxStreaming(_jax_space(path), chunk_rows=512).search(queries, k=5)
    np.testing.assert_array_equal(res.indices, ref.indices)


def test_streaming_k_exceeds_corpus(tmp_path, rng):
    data = rng.standard_normal((5, 8)).astype(np.float32)
    b = Builder()
    b.add_vector_space("v", dim=8)
    b.add_vectors("v", data)
    path = tmp_path / "tiny.mvt"
    b.build().save(path)
    res = StreamingSearcher(_open(path), chunk_rows=256, device="cpu").search(data[:2], k=9)
    assert res.indices.shape == (2, 9)
    assert (res.indices[:, 5:] == -1).all() and np.isneginf(res.scores[:, 5:]).all()
    assert np.isinf(res.distances[:, 5:]).all()
    assert res.indices[0, 0] == 0 and res.indices[1, 0] == 1
    ref = JaxStreaming(_jax_space(path), chunk_rows=256).search(data[:2], k=9)
    np.testing.assert_array_equal(res.indices, ref.indices)
    _same(res, _resident(path).search(data[:2], k=9))


def test_streaming_int8(tmp_path, rng):
    x = rng.standard_normal((600, 16)).astype(np.float32)
    b = Builder()
    b.add_vector_space("q", dim=16, dtype=DataType.INT8,
                       metric=DistanceMetric.INNER_PRODUCT)
    b.add_vectors("q", x)
    path = tmp_path / "q.mvt"
    b.build().save(path)
    queries = rng.standard_normal((3, 16)).astype(np.float32)
    got = StreamingSearcher(_open(path, "q"), chunk_rows=128, device="cpu").search(
        queries, k=8)
    _same(got, _resident(path, "q").search(queries, k=8))
    ref = JaxStreaming(_jax_space(path, "q"), chunk_rows=128).search(queries, k=8)
    np.testing.assert_array_equal(got.indices, ref.indices)
    np.testing.assert_array_equal(got.scores, ref.scores)  # integer dots, one scale


@pytest.mark.parametrize("dtype,metric", [
    (DataType.FLOAT16, DistanceMetric.L2),
    (DataType.UINT8, DistanceMetric.L2),       # the integer variant with code sums
    (DataType.UINT8, DistanceMetric.COSINE),   # the affine load
])
def test_streaming_native_prep_matches_fallback(tmp_path, rng, monkeypatch,
                                                dtype, metric):
    """The native fill of uint8 staging buffers (codec.cpp
    ``mvt_prep_u8_offset``) and its numpy twin give identical results on
    both uint8 routes, a short last chunk and a tombstone included (f16
    ships as stored, by the same ``copy_`` either way); and the resident
    engine's, and the JAX package's indices."""
    from metrovector_tpu_torch import native

    data = (
        rng.standard_normal((900, 20)).astype(np.float16).astype(np.float32)
        if dtype == DataType.FLOAT16
        else rng.integers(0, 256, (900, 20)).astype(np.float32)
    )
    b = Builder()
    b.add_vector_space("v", dim=20, dtype=dtype, metric=metric)
    b.add_vectors("v", data)
    b.delete_vector("v", 875)
    path = tmp_path / f"np_{int(dtype)}_{int(metric)}.mvt"
    b.build().save(path)
    queries = rng.standard_normal((3, 20)).astype(np.float32)

    assert native.available()
    res_native = StreamingSearcher(_open(path), chunk_rows=256, device="cpu").search(
        queries, k=7)
    monkeypatch.setattr(native, "prep_u8_offset", lambda *a, **k: None)
    res_numpy = StreamingSearcher(_open(path), chunk_rows=256, device="cpu").search(
        queries, k=7)
    _same(res_native, res_numpy)
    _same(res_native, _resident(path).search(queries, k=7))
    ref = JaxStreaming(_jax_space(path), chunk_rows=256).search(queries, k=7)
    np.testing.assert_array_equal(res_native.indices, ref.indices)
    np.testing.assert_allclose(res_native.scores, ref.scores, rtol=1e-5, atol=1e-4)


def test_twins_in_two_chunks_keep_the_lowest_row(tmp_path, rng):
    """Rows 10 and 1500 are equal and lie in different chunks (and rows 20
    and 21 in one): every tie goes to the lower row, as in a resident
    search and in the JAX package's."""
    data = rng.integers(0, 8, (2000, 16)).astype(np.float32)
    data[1500] = data[10]
    data[21] = data[20]
    b = Builder()
    b.add_vector_space("v", dim=16)
    b.add_vectors("v", data)
    path = tmp_path / "twins.mvt"
    b.build().save(path)
    queries = data[[10, 20, 1500]] + 0.25
    got = StreamingSearcher(_open(path), chunk_rows=256, device="cpu").search(queries, k=6)
    first = list(got.indices[0])
    assert first.index(10) < first.index(1500)
    assert list(got.indices[1]).index(20) < list(got.indices[1]).index(21)
    _same(got, _resident(path).search(queries, k=6))
    ref = JaxStreaming(_jax_space(path), chunk_rows=256).search(queries, k=6)
    np.testing.assert_array_equal(got.indices, ref.indices)
    np.testing.assert_array_equal(got.scores, ref.scores)  # integer data


def test_filter_that_empties_a_chunk(big_space, rng):
    """A predicate that keeps no row of chunk 1 (rows 256-511) and one row
    of chunk 3: that chunk contributes nothing and the answer is the
    resident engine's with the same filter."""
    path, data = big_space
    keep = np.ones(2000, bool)
    keep[256:512] = False
    keep[768:1024] = False
    keep[800] = True
    queries = np.concatenate([data[[300, 800]], rng.standard_normal((2, 32))]).astype(
        np.float32)
    got = StreamingSearcher(_open(path), chunk_rows=256, device="cpu").search(
        queries, k=10, filter_mask=keep)
    assert not np.isin(got.indices, np.flatnonzero(~keep)).any()
    assert got.indices[1, 0] == 800
    _same(got, _resident(path).search(queries, k=10, filter_mask=keep), exact=False)
    ref = JaxStreaming(_jax_space(path), chunk_rows=256).search(
        queries, k=10, filter_mask=keep)
    np.testing.assert_array_equal(got.indices, ref.indices)


def test_chunk_rows_off_the_row_multiple(big_space, rng):
    """1,003 rows a chunk round down to 1,000 (f32 blocks go by 8 rows),
    as in the JAX package; the answer does not move."""
    path, _ = big_space
    s = StreamingSearcher(_open(path), chunk_rows=1003, device="cpu")
    assert s.chunk_rows == JaxStreaming(_jax_space(path), chunk_rows=1003).chunk_rows == 1000
    queries = rng.standard_normal((3, 32)).astype(np.float32)
    _same(s.search(queries, k=9), _resident(path).search(queries, k=9), exact=False)
    assert s.last_trace["chunks"] == 2
    assert StreamingSearcher(_open(path), chunk_rows=3, device="cpu").chunk_rows == 8


@pytest.mark.parametrize("dtype,metric", [
    (DataType.BFLOAT16, DistanceMetric.L2),
    (DataType.FLOAT32, DistanceMetric.COSINE),
    (DataType.FLOAT32, DistanceMetric.INNER_PRODUCT),
    (DataType.INT8, DistanceMetric.L2),
    (DataType.UINT8, DistanceMetric.INNER_PRODUCT),
])
def test_other_dtypes_equal_the_resident_engine(tmp_path, rng, dtype, metric):
    data = rng.integers(0, 200, (700, 24)).astype(np.float32)
    if dtype == DataType.INT8:
        data -= 100
    b = Builder()
    b.add_vector_space("v", dim=24, dtype=dtype, metric=metric)
    b.add_vectors("v", data, ids=np.arange(700, dtype=np.uint64) * 3 + 11)
    b.delete_vector("v", 5)
    path = tmp_path / "d.mvt"
    b.build().save(path)
    queries = rng.integers(0, 200, (4, 24)).astype(np.float32)
    got = StreamingSearcher(_open(path), chunk_rows=200, device="cpu").search(queries, k=11)
    # cosine normalizes the queries: float dots
    _same(got, _resident(path).search(queries, k=11),
          exact=metric != DistanceMetric.COSINE)
    assert (got.ids == got.indices * 3 + 11).all()


def test_merge_keeps_the_carried_entry_on_a_tie():
    best_s = torch.tensor([[5.0, 3.0, float("-inf")]])
    best_i = torch.tensor([[4, 9, -1]], dtype=torch.int32)
    s = torch.tensor([[5.0, 3.0, 1.0]])
    i = torch.tensor([[12, 13, 14]], dtype=torch.int32)
    top_s, top_i = merge_topk(best_s, best_i, s, i, 4)
    assert top_i.tolist() == [[4, 12, 9, 13]] and top_s.tolist() == [[5.0, 5.0, 3.0, 3.0]]


def test_trace_and_guards(big_space, rng):
    path, _ = big_space
    s = StreamingSearcher(_open(path), chunk_rows=512, device="cpu")
    s.search(rng.standard_normal((2, 32)).astype(np.float32), k=3)
    # 2,000 rows of 128 padded f32 dims, their norms and the tombstone plane
    assert s.last_trace["chunks"] == 4
    assert s.last_trace["bytes"] == 2000 * (128 * 4 + 4 + 4)
    assert s.last_trace["scan_ms"] > 0
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            StreamingSearcher(_open(path))  # the default device is CUDA: no fallback


def test_card_times_from_the_events():
    """The card's side of a search from its copy and scan events: summed
    times, the share of the copies under a scan, and the busy time."""
    from metrovector_tpu_torch.parallel.streaming import _card_times

    class Ev:  # a recorded event at ``t`` ms
        def __init__(self, t):
            self.t = t

        def elapsed_time(self, other):
            return other.t - self.t

    def pairs(*spans):
        return [(Ev(a), Ev(b)) for a, b in spans]

    # copies 0-4, 4-8, 8-12; scans 4-5 (under copy 2) and 8-10 (under copy 3)
    got = _card_times({"copy": pairs((0, 4), (4, 8), (8, 12)),
                       "scan": pairs((4, 5), (8, 10), (12, 13))})
    assert got == {"copy_ms": 12, "scan_ms": 4, "hidden": 3 / 12, "card_ms": 13}
    # a gap between the copies and the last scan is not busy time
    got = _card_times({"copy": pairs((0, 2)), "scan": pairs((5, 6))})
    assert got == {"copy_ms": 2, "scan_ms": 1, "hidden": 0.0, "card_ms": 3}
