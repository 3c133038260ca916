"""The port's PQ path against the JAX package on the CPU: k-means and PQ
training from the same seeds, encoding and the code helpers, a JAX
``PQIndex`` carried across by ``from_state`` and searched by both (the JAX
one on its XLA backend, and on its Pallas backend with a bf16 LUT), the file round trip and the code-only open, and
the error cases of ``tests/test_pq.py``.

Tolerance. Parity searches use integer-valued rows, queries and codebooks,
so every LUT entry, ADC sum and exact L2/IP score is an exact f32 integer:
there results must be identical. Cosine normalizes, so it is held to the
f32 band of ``_torch_parity`` against float64 scores. Trained centroids are
means, compared with ``allclose`` (rtol 1e-6); assignments and codes must
be identical.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from metrovector_tpu import Builder, DataType, DistanceMetric, Reader
from metrovector_tpu_torch.errors import DimensionMismatchError
from metrovector_tpu.index import pq as jax_pq
from metrovector_tpu.index.ivf import train_kmeans as jax_train_kmeans
from metrovector_tpu.ops import numpy_oracle
from metrovector_tpu_torch.index import ivf, pq
from metrovector_tpu_torch.index.pq import PQIndex

from _torch_parity import METRICS, assert_topk_match, exact_scores, tolerance


def _clusters(seed, n=240, d=16, c=6):
    """Integer-valued rows around well-separated integer centers."""
    rng = np.random.default_rng(seed)
    centers = rng.integers(0, 8, (c, d)).astype(np.float32) * 40
    rows = centers[rng.integers(0, c, n)] + rng.integers(-3, 4, (n, d))
    return rows.astype(np.float32), rng


@pytest.mark.parametrize("sample", [None, 200])
def test_train_kmeans_matches_reference(sample):
    data, _ = _clusters(1)
    c_port, a_port = ivf.train_kmeans(data, 6, iters=5, seed=3, sample=sample,
                                      device="cpu")
    c_ref, a_ref = jax_train_kmeans(data, 6, iters=5, seed=3, sample=sample)
    np.testing.assert_allclose(c_port, c_ref, rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(a_port, a_ref)
    assert a_port.dtype == np.int32


def test_train_pq_and_codes_match_reference():
    data, _ = _clusters(2)
    books = pq.train_pq(data, m=4, ksub=8, iters=4, seed=1, device="cpu")
    ref_books = jax_pq.train_pq(data, m=4, ksub=8, iters=4, seed=1)
    np.testing.assert_allclose(books, ref_books, rtol=1e-6, atol=1e-6)
    codes = pq.encode_pq(data, ref_books, device="cpu")
    np.testing.assert_array_equal(codes, jax_pq.encode_pq(data, ref_books))
    assert codes.dtype == np.uint8
    np.testing.assert_array_equal(pq.reconstruct_pq(codes, ref_books),
                                  jax_pq.reconstruct_pq(codes, ref_books))
    for m in (4, 3):  # even and odd m
        packed = pq.pack_codes4(codes[:, :m])
        np.testing.assert_array_equal(packed, jax_pq.pack_codes4(codes[:, :m]))
        np.testing.assert_array_equal(pq.unpack_codes4(packed, m), codes[:, :m])
    with pytest.raises(ValueError, match="4-bit"):
        pq.pack_codes4(np.full((2, 2), 16, np.uint8))


def _ref_index(metric, packed4, seed=4):
    """A JAX index over integer rows with integer codebooks, ids and two
    tombstones."""
    data, rng = _clusters(seed, n=300)
    ksub = 16
    books = np.rint(jax_pq.train_pq(data, m=4, ksub=ksub, iters=3, seed=seed))
    tomb = np.zeros(len(data), bool)
    tomb[[5, 77]] = True
    ids = (np.arange(len(data), dtype=np.uint64) * np.uint64(3) + np.uint64(11))
    ref = jax_pq.PQIndex.build(data, metric, codebooks=books, pack4=packed4,
                               valid_mask=tomb, ids=ids[::-1].copy())
    q = data[rng.integers(0, len(data), 6)] + rng.integers(-9, 10, (6, 16))
    return ref, data, q.astype(np.float32), rng


def _state(ref):
    state = {name: None if getattr(ref, name) is None else np.asarray(getattr(ref, name))
             for name in ("codebooks", "codes", "recon_norms", "db", "db_norms", "valid")}
    state.update(metric=int(ref.metric), dim=ref.dim,
                 num_vectors=ref.num_vectors, packed4=ref.packed4,
                 host_ids=ref.host_ids)
    return state


def _same(a, b, metric, q, data, live):
    if metric == DistanceMetric.COSINE:
        assert_topk_match((a.scores, a.indices), (b.scores, b.indices),
                          exact=False, tol=tolerance(q, data, metric),
                          scores64=exact_scores(q, data, metric, live))
        return
    np.testing.assert_array_equal(a.indices, b.indices)
    np.testing.assert_array_equal(a.scores, b.scores)
    np.testing.assert_array_equal(a.ids, b.ids)
    np.testing.assert_allclose(a.distances, b.distances, rtol=1e-6)


@pytest.mark.parametrize("rerank", [0, 40])
@pytest.mark.parametrize("packed4", [False, True], ids=["u8", "packed4"])
@pytest.mark.parametrize("metric", METRICS)
def test_from_state_search_matches_reference(metric, packed4, rerank):
    """Filters, tombstones (file and ``delete_rows``) and ids included."""
    ref, data, q, rng = _ref_index(metric, packed4)
    port = PQIndex.from_state(_state(ref), device="cpu")
    assert port.packed4 == packed4 and port.code_bytes_per_vector == ref.code_bytes_per_vector
    mask = rng.random(len(data)) < 0.6
    live = mask.copy()
    live[[5, 77]] = False
    if metric != DistanceMetric.COSINE or rerank:  # cosine ADC: not exact data
        scores_on = data if rerank else pq.reconstruct_pq(
            pq.unpack_codes4(np.asarray(ref.codes), 4) if packed4
            else np.asarray(ref.codes), ref.codebooks)
        for fm in (None, mask, port.prepare_filter(mask)):
            ref_fm = ref.prepare_filter(mask) if fm is not None and not isinstance(
                fm, np.ndarray) else fm
            a = port.search(q, k=10, rerank=rerank, filter_mask=fm)
            b = ref.search(q, k=10, rerank=rerank, filter_mask=ref_fm, backend="xla")
            _same(a, b, metric, q, scores_on,
                  live if fm is not None else np.isin(np.arange(len(data)),
                                                      [5, 77], invert=True))
    victims = port.search(q, k=1, rerank=rerank).indices[:, 0]
    port.delete_rows(victims)
    ref.delete_rows(victims)
    a = port.search(q, k=10, rerank=rerank)
    b = ref.search(q, k=10, rerank=rerank, backend="xla")
    assert not np.isin(a.indices, [5, 77, *victims]).any()
    if metric != DistanceMetric.COSINE:
        _same(a, b, metric, q, data, None)


@pytest.mark.parametrize("rerank", [0, 40])
@pytest.mark.parametrize("packed4", [False, True], ids=["u8", "packed4"])
@pytest.mark.parametrize("metric", METRICS)
def test_bf16_lut_matches_pallas_reference(metric, packed4, rerank):
    """``exact_lut=False`` (a bf16 LUT), held against the reference's
    ``backend="pallas"`` (the fused ADC kernel, interpreted on the CPU; its
    ``"xla"`` backend disagrees with it for cosine). On the integer data of
    ``_ref_index`` every bf16 LUT entry is an integer, so L2/IP sums are
    exact: identical results. Cosine (unit queries) is held to the f32 band
    against float64 scores of the rows it ranks: the reconstructions
    without a re-rank, the original rows with one."""
    ref, data, q, _ = _ref_index(metric, packed4)
    port = PQIndex.from_state(_state(ref), device="cpu")
    a = port.search(q, k=10, rerank=rerank, exact_lut=False)
    b = ref.search(q, k=10, rerank=rerank, exact_lut=False, backend="pallas")
    codes = np.asarray(ref.codes)
    scores_on = data if rerank else pq.reconstruct_pq(
        pq.unpack_codes4(codes, 4) if packed4 else codes, ref.codebooks)
    _same(a, b, metric, q, scores_on,
          np.isin(np.arange(len(data)), [5, 77], invert=True))


@pytest.mark.parametrize("metric", METRICS)
def test_full_rerank_recovers_oracle(rng, metric):
    """rerank = N rescoring the whole corpus equals the exact oracle over
    the original rows (mirrors tests/test_pq.py)."""
    data = rng.standard_normal((200, 16)).astype(np.float32)
    idx = PQIndex.build(data, metric, m=4, ksub=16, iters=4, device="cpu")
    q = rng.standard_normal((5, 16)).astype(np.float32)
    res = idx.search(q, k=10, rerank=200)
    _, oi = numpy_oracle(q, data, 10, metric)
    np.testing.assert_array_equal(res.indices, oi)


@pytest.mark.parametrize("k", [10, 300])
@pytest.mark.parametrize("metric", [DistanceMetric.L2, DistanceMetric.INNER_PRODUCT])
def test_full_rerank_matches_reference_on_duplicate_rows(metric, k):
    """rerank = N within the ADC and rescore kernels' limits runs the scan
    and the re-rank, as the reference does. Every row appears twice with
    different codes, so the ADC order of a pair is not its row order: the
    re-rank's ties by candidate position then differ from ties by the
    lowest row, which exact search gives. k = N = 300 is answered too."""
    data, rng = _clusters(5, n=150)
    data = np.concatenate([data, data])
    books = np.rint(jax_pq.train_pq(data, m=4, ksub=16, iters=3, seed=5))
    codes = rng.integers(0, 16, (len(data), 4)).astype(np.uint8)
    recon = jax_pq.reconstruct_pq(codes, books).astype(np.float64)
    ref = dataclasses.replace(
        jax_pq.PQIndex.build(data, metric, codebooks=books),
        codes=jnp.asarray(codes),
        recon_norms=jnp.asarray((recon ** 2).sum(1).astype(np.float32)))
    port = PQIndex.from_state(_state(ref), device="cpu")
    q = (data[rng.integers(0, 150, 5)] + rng.integers(-9, 10, (5, 16))).astype(np.float32)
    a = port.search(q, k=k, rerank=len(data))
    b = ref.search(q, k=k, rerank=len(data), backend="xla")
    _same(a, b, metric, q, data, None)
    _, lowest_row_first = numpy_oracle(q, data, k, metric)
    assert not np.array_equal(a.indices, lowest_row_first)


@pytest.mark.parametrize("k", [1, 10, 100, 300])
@pytest.mark.parametrize("packed4", [False, True], ids=["u8", "packed4"])
def test_adc_ties_on_duplicated_codes_match_reference(packed4, k):
    """Every code row has twins (30 distinct rows, repeated), so ADC scores
    tie across the corpus and the lower row decides, at k up to N = 300,
    without a re-rank: the ADC scan's own order, as the JAX index gives it."""
    data, rng = _clusters(7, n=300)
    books = np.rint(jax_pq.train_pq(data, m=4, ksub=16, iters=3, seed=7))
    codes = rng.integers(0, 16, (30, 4)).astype(np.uint8)[rng.integers(0, 30, len(data))]
    recon = jax_pq.reconstruct_pq(codes, books).astype(np.float64)
    ref = dataclasses.replace(
        jax_pq.PQIndex.build(data, DistanceMetric.L2, codebooks=books, pack4=packed4),
        codes=jnp.asarray(jax_pq.pack_codes4(codes) if packed4 else codes),
        recon_norms=jnp.asarray((recon ** 2).sum(1).astype(np.float32)))
    port = PQIndex.from_state(_state(ref), device="cpu")
    q = (data[rng.integers(0, 300, 5)] + rng.integers(-9, 10, (5, 16))).astype(np.float32)
    a = port.search(q, k=k, rerank=0)
    b = ref.search(q, k=k, rerank=0, backend="xla")
    _same(a, b, DistanceMetric.L2, q, recon, None)
    first_twin = {c.tobytes(): r for r, c in reversed(list(enumerate(codes)))}
    if k == 1:  # the lowest of the tied twins
        assert all(r == first_twin[codes[r].tobytes()] for r in a.indices[:, 0])
    else:
        assert len(np.unique(a.scores)) < a.scores.size  # ties were decided


@pytest.mark.parametrize("rerank", [1025, 1500, 2999])
@pytest.mark.parametrize("metric", [DistanceMetric.L2, DistanceMetric.INNER_PRODUCT])
def test_rerank_above_1024_matches_reference(metric, rerank):
    """1024 < rerank < N on 3,000 rows, every row twice with different
    codes: the ADC fetch and the re-rank with ties by candidate position,
    as JAX ``search(backend="xla")`` gives them (the old limit raised)."""
    data, rng = _clusters(6, n=1500)
    data = np.concatenate([data, data])
    books = np.rint(jax_pq.train_pq(data, m=4, ksub=16, iters=3, seed=6))
    codes = rng.integers(0, 16, (len(data), 4)).astype(np.uint8)
    recon = jax_pq.reconstruct_pq(codes, books).astype(np.float64)
    ref = dataclasses.replace(
        jax_pq.PQIndex.build(data, metric, codebooks=books),
        codes=jnp.asarray(codes),
        recon_norms=jnp.asarray((recon ** 2).sum(1).astype(np.float32)))
    port = PQIndex.from_state(_state(ref), device="cpu")
    q = (data[rng.integers(0, 1500, 4)] + rng.integers(-9, 10, (4, 16))).astype(np.float32)
    for k in (10, 300):
        _same(port.search(q, k=k, rerank=rerank),
              ref.search(q, k=k, rerank=rerank, backend="xla"), metric, q, data, None)


def test_adc_ranks_like_reconstructed_bruteforce(rng):
    data = rng.standard_normal((300, 16)).astype(np.float32)
    idx = PQIndex.build(data, DistanceMetric.L2, m=4, ksub=16, iters=5,
                        device="cpu")
    recon = pq.reconstruct_pq(idx.codes.numpy(), idx.codebooks)
    q = rng.standard_normal((7, 16)).astype(np.float32)
    _, oi = numpy_oracle(q, recon, 10, DistanceMetric.L2)
    np.testing.assert_array_equal(idx.search(q, k=10).indices, oi)


def _pq_file(tmp_path, rng, n=120, deleted=()):
    data = rng.standard_normal((n, 16)).astype(np.float32)
    books = pq.train_pq(data, m=4, ksub=16, iters=4, device="cpu")
    codes = pq.encode_pq(data, books, device="cpu")
    b = Builder()
    b.add_vector_space("s", dim=16)
    b.add_vectors("s", data)
    b.set_pq_index("s", books, codes)
    for r in deleted:
        b.delete_vector("s", r)
    path = tmp_path / "pq.mvt"
    b.build().save(path)
    return Reader.open(path).vector_space("s"), data, books, codes


def test_roundtrip_through_file(tmp_path, rng):
    sp, data, books, codes = _pq_file(tmp_path, rng)
    idx = PQIndex.from_space(sp, device="cpu")  # reuses the sidecar
    np.testing.assert_array_equal(idx.codes.numpy(), codes)
    np.testing.assert_array_equal(idx.codebooks, books)
    q = rng.standard_normal((4, 16)).astype(np.float32)
    _, oi = numpy_oracle(q, data, 5, DistanceMetric.L2)
    np.testing.assert_array_equal(idx.search(q, k=5, rerank=120).indices, oi)
    ref = jax_pq.PQIndex.from_space(sp)
    a, b = idx.search(q, k=5, rerank=30), ref.search(q, k=5, rerank=30, backend="xla")
    np.testing.assert_array_equal(a.indices, b.indices)


def test_code_only_from_space_skips_dense_rows(tmp_path, rng):
    sp, data, books, codes = _pq_file(tmp_path, rng, n=90, deleted=(4,))
    calls = []
    orig = sp.to_numpy
    sp.to_numpy = lambda: (calls.append(1), orig())[1]
    idx = PQIndex.from_space(sp, keep_vectors=False, device="cpu")
    assert not calls and idx.db is None  # dense rows never touched
    q = rng.standard_normal((3, 16)).astype(np.float32)
    recon = pq.reconstruct_pq(codes, books)
    live = np.arange(90) != 4
    _, oi = numpy_oracle(q, recon[live], 5, DistanceMetric.L2)
    np.testing.assert_array_equal(idx.search(q, k=5).indices,
                                  np.arange(90)[live][oi])
    with pytest.raises(ValueError, match="rerank"):
        idx.search(q, k=5, rerank=20)


def test_tombstones_and_quantized_space(tmp_path, rng):
    data = (rng.standard_normal((80, 8)) * 0.5).astype(np.float32)
    b = Builder()
    b.add_vector_space("s", dim=8, dtype=DataType.INT8)
    b.add_vectors("s", data)
    b.delete_vector("s", 3)
    path = tmp_path / "q.mvt"
    b.build().save(path)
    idx = PQIndex.from_space(Reader.open(path).vector_space("s"), m=2, ksub=16,
                             iters=4, device="cpu")
    res = idx.search(data[:3], k=2, rerank=16)
    assert res.indices[0, 0] == 0 and res.indices[2, 0] == 2
    assert 3 not in res.indices


def test_error_cases(rng):
    data = rng.standard_normal((100, 8)).astype(np.float32)
    with pytest.raises(ValueError, match="not divisible"):
        pq.train_pq(rng.standard_normal((50, 10)).astype(np.float32), m=4,
                    device="cpu")
    no_db = PQIndex.build(data, DistanceMetric.L2, m=2, ksub=8,
                          keep_vectors=False, device="cpu")
    with pytest.raises(ValueError, match="rerank"):
        no_db.search(data[:2], k=5, rerank=20)
    with pytest.raises(DimensionMismatchError):
        no_db.search(np.zeros((1, 12), np.float32), k=3)
    small = PQIndex.build(data[:6], DistanceMetric.L2, m=2, ksub=4, iters=3,
                          device="cpu")
    res = small.search(data[:2], k=10)
    assert res.indices.shape == (2, 10) and (res.indices[:, 6:] == -1).all()
    with pytest.raises(ValueError, match="pack4"):
        PQIndex.build(data, DistanceMetric.L2, m=2, ksub=32, pack4=True,
                      device="cpu")


def test_unported_options_raise(rng):
    data = rng.standard_normal((60, 8)).astype(np.float32)
    idx = PQIndex.build(data, DistanceMetric.L2, m=2, ksub=8, device="cpu")
    # the int8 LUT serves now (tests/test_torch_adc_int8.py holds it)
    assert idx.search(data[:1], k=3, int8_lut=True).indices.shape == (1, 3)
    with pytest.raises(DimensionMismatchError):  # add_rows serves now
        idx.add_rows(data[:1, :4])
    with pytest.raises(ValueError, match="CUDA kernels"):  # the CPU has no grid
        idx.autotune()
    with pytest.raises(ValueError, match="backend"):
        idx.search(data[:1], k=3, backend="pallas")
    idx.search(data[:1], k=3, block_rows=512)  # accepted and ignored


def test_recommended_rerank_matches_reference(rng):
    ref, *_ = _ref_index(DistanceMetric.L2, True)
    port = PQIndex.from_state(_state(ref), device="cpu")
    for target in (0.5, 0.7, 0.95, 1.0):
        assert port.recommended_rerank(25, target) == ref.recommended_rerank(25, target)
    with pytest.raises(ValueError):
        port.recommended_rerank(10, 0.0)


def test_cuda_request_without_cuda_raises(rng):
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA; the refusal is for hosts without it")
    data = rng.standard_normal((40, 8)).astype(np.float32)
    with pytest.raises(RuntimeError, match="cuda"):
        PQIndex.build(data, DistanceMetric.L2, m=2, ksub=4)
    with pytest.raises(RuntimeError, match="cuda"):
        pq.encode_pq(data, np.zeros((2, 4, 4), np.float32))
    ref, *_ = _ref_index(DistanceMetric.L2, False)
    with pytest.raises(RuntimeError, match="cuda"):
        PQIndex.from_state(_state(ref))
