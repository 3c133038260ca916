"""Live mutation in the port against the JAX package on the CPU: the same
``add_rows`` and ``delete_rows`` steps, made from a seed with numpy, on a
JAX ``DeviceSpace`` (searched by its XLA backend, or its Pallas kernel in
interpret mode for the integer spaces) and on the port's (``device="cpu"``);
then PQ (pq8 and packed pq4), IVF and IVF-PQ (both serving modes, overflow
buckets, ``rebuild``) the same way.

Mirrors the non-HNSW tests of ``tests/test_online_mutation.py``, the device
half of ``tests/test_vector_ids.py`` and ``tests/test_append.py`` (ids on a
grown space, and the grown space persisted), a mutation sequence in the
style of ``tests/test_fuzz_equivalence.py`` and the ``add_rows`` steps of
``tests/test_ivfpq.py``'s lifecycle. After each step the port's resident
state is held to the reference's: ``padded_rows``, the block, the norms,
the code sums, the validity mask and the ID column.

Also the snapshot contract, which the reference does not have to keep: a
batch launched before a growth step and finalized after it equals a search
of the old snapshot, and a writer thread against a ``MicroBatcher`` yields
only answers that some published snapshot gives.

Tolerance. Integer-valued rows and queries make every f32 score exact: the
results must be identical. Where a space's scale is not 1 or its metric is
cosine, the bands of ``tests/test_torch_quantized.py`` (ROADMAP Queue C):
identical indices, scores within 16 f32 ulp of the largest term (cosine 4
ulp). An f16 space appends f16-representable rows exactly as the reference
(which holds an f16 block as f32) does; other rows lie within one f16 ulp of
the reference's f32 values.
"""

import threading
import time

import numpy as np
import pytest
import torch

from metrovector_tpu import Builder, DataType, DistanceMetric, Reader
from metrovector_tpu.engine import DeviceSpace as JaxSpace
from metrovector_tpu.engine import SearchEngine as JaxEngine
from metrovector_tpu.index import ivf as jax_ivf
from metrovector_tpu.index import ivfpq as jax_ivfpq
from metrovector_tpu.index import pq as jax_pq
from metrovector_tpu.ops import numpy_oracle
from metrovector_tpu_torch import Reader as PortReader
from metrovector_tpu_torch import builder_from_reader
from metrovector_tpu_torch.engine import DeviceSpace, SearchEngine
from metrovector_tpu_torch.errors import (
    DimensionMismatchError,
    IndexOutOfBoundsError,
    InvalidVectorTypeError,
    VectorIdNotFoundError,
)
from metrovector_tpu_torch.index.ivf import IVFIndex
from metrovector_tpu_torch.index.ivfpq import IVFPQIndex
from metrovector_tpu_torch.index.pq import PQIndex
from metrovector_tpu_torch.ops.adc_kernel import int8_lut_route
from metrovector_tpu_torch.serving import MicroBatcher

from _torch_parity import exact_scores

L2, IP, COS = DistanceMetric.L2, DistanceMetric.INNER_PRODUCT, DistanceMetric.COSINE
D = 16


def _file(tmp_path, data, dtype=DataType.FLOAT32, metric=L2, ids=None,
          quant=None, name="m.mvt"):
    b = Builder()
    h = b.add_vector_space("e", dim=data.shape[1], dtype=dtype, metric=metric)
    if quant is not None:
        h.with_quantization(scale=quant[0], zero_point=quant[1])
    b.add_vectors("e", data, ids=ids)
    p = tmp_path / name
    b.build().save(p)
    return p


def _pair(path, precision="highest"):
    """(reference DeviceSpace, port DeviceSpace) of one file."""
    ref = JaxSpace.from_space(Reader.open(path).vector_space("e"),
                              precision=precision)
    port = DeviceSpace.from_space(PortReader.open(path).vector_space("e"),
                                  device="cpu", precision=precision)
    return ref, port


def _bits(a) -> np.ndarray:
    """A block's values as comparable host numbers (bf16 by its bits)."""
    if isinstance(a, torch.Tensor):
        if a.dtype == torch.bfloat16:
            return a.view(torch.int16).numpy().view(np.uint16)
        return a.numpy()
    a = np.asarray(a)
    return a.view(np.uint16) if a.dtype.name == "bfloat16" else a


def _assert_same_state(ref, port, f16_band=False):
    """The port's resident state equals the reference's after a step."""
    assert port.num_valid == ref.num_valid
    assert port.padded_rows == ref.padded_rows
    assert port.padded_dim == ref.padded_dim
    got, want = _bits(port.data), _bits(ref.data)
    if port.data.dtype == torch.float16:  # the reference holds f32
        got = got.astype(np.float32)
        if f16_band:
            ulp = np.spacing(np.abs(want).astype(np.float16)).astype(np.float32)
            assert (np.abs(got - want) <= ulp).all()
        else:
            np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(port.norms.numpy(), np.asarray(ref.norms))
    for name in ("valid_mask", "rowsums"):
        a, b = getattr(port, name), getattr(ref, name)
        assert (a is None) == (b is None), name
        if a is not None:
            np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=name)
    if ref.host_ids is None:
        assert port.host_ids is None
    else:
        np.testing.assert_array_equal(port.host_ids, ref.host_ids)


def _ulps(got, want) -> np.ndarray:
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return np.abs(got.astype(np.float64) - want) / np.spacing(np.abs(want))


def _assert_results(a, b, band_terms=None, cosine=False):
    np.testing.assert_array_equal(a.indices, b.indices)
    np.testing.assert_array_equal(a.ids, b.ids)
    live = b.indices >= 0
    if cosine:
        assert _ulps(a.scores[live], b.scores[live]).max(initial=0) <= 4
    elif band_terms is None:
        np.testing.assert_array_equal(a.scores, b.scores)
    else:
        tol = 16 * np.spacing(np.float32(band_terms))[:, None]
        assert (np.abs(a.scores.astype(np.float64) - b.scores) <= tol)[live].all()


# (dtype, precision, metric, quantization, reference backend)
CASES = {
    "f32_highest": (DataType.FLOAT32, "highest", L2, None, "xla"),
    "f32_default": (DataType.FLOAT32, "default", L2, None, "xla"),
    "f32_high_verified": (DataType.FLOAT32, "high_verified", L2, None, "pallas"),
    "f16_highest": (DataType.FLOAT16, "highest", L2, None, "xla"),
    "f16_default": (DataType.FLOAT16, "default", L2, None, "xla"),
    "bf16": (DataType.BFLOAT16, "highest", L2, None, "xla"),
    "int8_l2": (DataType.INT8, "highest", L2, (1.0, 0.0), "pallas"),
    "int8_scaled_ip": (DataType.INT8, "highest", IP, (0.5, 0.0), "pallas"),
    "uint8_l2": (DataType.UINT8, "highest", L2, (1.0, 0.0), "pallas"),
    "uint8_cosine": (DataType.UINT8, "highest", COS, (0.75, 3.0), "pallas"),
}


def _rows(rng, n, dtype, float_rows=False):
    """Integer-valued rows in the dtype's code range (as f32; exact in f16
    and bf16), or float rows to be quantized."""
    if dtype == DataType.INT8:
        if float_rows:
            return rng.uniform(-60, 60, (n, D)).astype(np.float32)
        return rng.integers(-128, 128, (n, D)).astype(np.float32)
    if dtype == DataType.UINT8:
        if float_rows:
            return rng.uniform(0, 180, (n, D)).astype(np.float32)
        return rng.integers(0, 256, (n, D)).astype(np.float32)
    return rng.integers(-8, 9, (n, D)).astype(np.float32)


@pytest.mark.parametrize("case", list(CASES))
def test_add_and_delete_rows_match_reference(tmp_path, case):
    """Every dtype and precision: an append within the tile headroom, one
    that crosses capacity (float rows quantized by the stored calibration
    where the space is integer), deletes by position and by id, and another
    append; state and searches equal to the reference after each step."""
    dtype, precision, metric, quant, backend = CASES[case]
    rng = np.random.default_rng(7)
    data = _rows(rng, 37, dtype)
    ids = np.arange(37, dtype=np.uint64) * 3 + 100
    path = _file(tmp_path, data, dtype, metric, ids=ids, quant=quant)
    ref, port = _pair(path, precision)
    eng = SearchEngine(port)
    ref_eng = JaxEngine(ref, backend=backend, interpret=True, precision=precision)
    q = _rows(rng, 5, dtype)
    band = None  # integer queries quantize inexactly: the bands apply
    if quant is not None and metric != COS:
        band = lambda: 2 * np.abs(q @ _deq(port).T).max(1) + port.norms.max().item()

    def check(step):
        _assert_same_state(ref, port)
        a, b = eng.search(q, k=7), ref_eng.search(q, k=7)
        _assert_results(a, b, band() if band else None, cosine=metric == COS)
        assert len(a.indices) == 5, step

    check("open")
    next_id = 1000
    for step, (n, float_rows) in enumerate([(3, False), (30, True), (80, False)]):
        rows = _rows(rng, n, dtype, float_rows=float_rows)
        new_ids = np.arange(next_id, next_id + n, dtype=np.uint64)
        next_id += n
        ref.add_rows(rows, ids=new_ids)
        port.add_rows(rows, ids=new_ids)
        check(f"add {step}")
        if step == 1:
            ref.delete_rows(rows=[0, port.num_valid - 1])
            port.delete_rows(rows=[0, port.num_valid - 1])
            check("delete by position")
            ref.delete_rows(ids=[103, 1001])
            port.delete_rows(ids=[103, 1001])
            check("delete by id")


def _deq(space) -> np.ndarray:
    """The dequantized logical rows of a port space (f32)."""
    x = space.data[: space.num_valid, : space.dim].float().numpy()
    if space.dtype == DataType.UINT8:
        return (x + 128 - space.zero_point) * space.scale
    return x * space.scale


@pytest.mark.parametrize("dtype", [DataType.FLOAT16], ids=["f16"])
def test_f16_space_rounds_appended_rows_where_reference_keeps_f32(tmp_path, dtype):
    """The one difference from the reference: it holds an f16 block as f32,
    so rows it appends stay unrounded; the port keeps the block in f16 and
    rounds them (to nearest even), within one f16 ulp of the input. Norms
    are the f32 input's on both sides. Rows that f16 represents are
    appended identically (test_add_and_delete_rows_match_reference)."""
    rng = np.random.default_rng(3)
    path = _file(tmp_path, _rows(rng, 20, dtype), dtype)
    ref, port = _pair(path)
    rows = rng.standard_normal((9, D)).astype(np.float32)
    ref.add_rows(rows)
    port.add_rows(rows)
    assert port.data.dtype == torch.float16
    _assert_same_state(ref, port, f16_band=True)
    got = port.data[20:29, :D].numpy()
    np.testing.assert_array_equal(got, rows.astype(np.float16))
    assert (got.astype(np.float32) != rows).any()  # rounded, unlike the reference


@pytest.mark.parametrize("case", ["f32_default", "bf16", "f16_highest"])
def test_float_space_norms_are_of_the_f32_input(tmp_path, case):
    """The reference's quirk, kept: a float space takes the squared norms of
    the f32 rows given to add_rows, not of the rounded rows it stores (so
    an L2 score of an appended row uses a norm its stored row does not
    have)."""
    dtype, precision, *_ = CASES[case]
    rng = np.random.default_rng(4)
    path = _file(tmp_path, _rows(rng, 20, dtype), dtype)
    ref, port = _pair(path, precision)
    rows = rng.standard_normal((6, D)).astype(np.float32)
    ref.add_rows(rows)
    port.add_rows(rows)
    want = np.einsum("ij,ij->i", rows, rows, dtype=np.float64).astype(np.float32)
    np.testing.assert_array_equal(port.norms[20:26].numpy(), want)
    np.testing.assert_array_equal(np.asarray(ref.norms)[20:26], want)
    stored = port.data[20:26, :D].float().numpy().astype(np.float64)
    assert ((stored ** 2).sum(1).astype(np.float32) != want).any()


def test_add_rows_within_capacity_keeps_the_tensors(tmp_path):
    """The counterpart of ``test_add_rows_within_capacity_no_shape_change``:
    rows that fit the tile headroom go into the live tensors (same
    ``data_ptr``), one more grows capacity by the reference's rule."""
    rng = np.random.default_rng(5)
    path = _file(tmp_path, _rows(rng, 37, DataType.FLOAT32), ids=None)
    ref, port = _pair(path)
    cap0, ptr0 = port.padded_rows, port.data.data_ptr()
    headroom = cap0 - port.num_valid
    assert headroom > 0
    rows = _rows(rng, headroom, DataType.FLOAT32)
    ref.add_rows(rows)
    port.add_rows(rows)
    assert port.padded_rows == cap0 and port.data.data_ptr() == ptr0
    _assert_same_state(ref, port)
    one = _rows(rng, 1, DataType.FLOAT32)
    ref.add_rows(one)
    port.add_rows(one)
    assert port.padded_rows > cap0 and port.data.data_ptr() != ptr0
    _assert_same_state(ref, port)
    for reserve in (1.5, 3.0):  # a large append and another reserve factor
        rows = _rows(rng, 200, DataType.FLOAT32)
        ref.add_rows(rows, reserve=reserve)
        port.add_rows(rows, reserve=reserve)
        _assert_same_state(ref, port)


def test_add_rows_ids_discipline(tmp_path):
    rng = np.random.default_rng(6)
    data = _rows(rng, 40, DataType.FLOAT32)
    path = _file(tmp_path, data, ids=np.arange(40, dtype=np.uint64) * 2)
    _, port = _pair(path)
    with pytest.raises(InvalidVectorTypeError):
        port.add_rows(_rows(rng, 2, DataType.FLOAT32))
    with pytest.raises(InvalidVectorTypeError):  # a colliding id
        port.add_rows(_rows(rng, 1, DataType.FLOAT32), ids=np.asarray([0], np.uint64))
    with pytest.raises(DimensionMismatchError):
        port.add_rows(_rows(rng, 2, DataType.FLOAT32), ids=np.asarray([5], np.uint64))
    with pytest.raises(DimensionMismatchError):
        port.add_rows(np.zeros((1, D + 1), np.float32), ids=np.asarray([5], np.uint64))
    assert port.num_valid == 40  # nothing was published
    new = _rows(rng, 2, DataType.FLOAT32) + 100
    port.add_rows(new, ids=np.asarray([1001, 1003], np.uint64))
    res = SearchEngine(port).search(new[:1], k=1)
    assert res.ids[0, 0] == 1001 and res.indices[0, 0] == 40
    path2 = _file(tmp_path, data, name="noid.mvt")
    _, port2 = _pair(path2)
    with pytest.raises(InvalidVectorTypeError):
        port2.add_rows(new[:1], ids=np.asarray([5], np.uint64))


def test_delete_rows_errors_and_empty_space(tmp_path):
    rng = np.random.default_rng(8)
    path = _file(tmp_path, _rows(rng, 40, DataType.FLOAT32),
                 ids=np.arange(40, dtype=np.uint64) * 2)
    _, port = _pair(path)
    with pytest.raises(IndexOutOfBoundsError):
        port.delete_rows(rows=[40])
    with pytest.raises(VectorIdNotFoundError):
        port.delete_rows(ids=[99999])
    with pytest.raises(KeyError):  # the error is a KeyError too
        port.delete_rows(ids=[99999])
    assert port.valid_mask is None  # nothing was published
    port.delete_rows(rows=[3])
    port.delete_rows(ids=[10])  # id 10 is row 5
    res = SearchEngine(port).search(_rows(rng, 4, DataType.FLOAT32), k=40)
    assert not np.isin(res.indices, [3, 5]).any() and (res.indices[:, -2:] == -1).all()
    # an empty space takes its first rows
    path = _file(tmp_path, np.zeros((0, D), np.float32), name="empty.mvt")
    ref, port = _pair(path)
    rows = _rows(rng, 12, DataType.FLOAT32)
    ref.add_rows(rows)
    port.add_rows(rows)
    _assert_same_state(ref, port)
    got = SearchEngine(port).search(rows[:3], k=2)
    want = JaxEngine(ref, backend="xla").search(rows[:3], k=2)
    _assert_results(got, want)
    port.add_rows(np.zeros((0, D), np.float32))  # an empty append: no step
    assert port.num_valid == 12


def test_prepared_filter_from_before_growth_is_rejected(tmp_path):
    """A filter prepared before an append names the old rows: it is
    rejected, as in the reference, and never applied to the new ones."""
    rng = np.random.default_rng(9)
    path = _file(tmp_path, _rows(rng, 40, DataType.FLOAT32))
    _, port = _pair(path)
    eng = SearchEngine(port)
    prepared = eng.prepare_filter(np.ones(40, bool))
    port.add_rows(_rows(rng, 30, DataType.FLOAT32))
    with pytest.raises(DimensionMismatchError):
        eng.search(_rows(rng, 2, DataType.FLOAT32), k=3, filter_mask=prepared)
    fresh = eng.prepare_filter(np.arange(70) % 2 == 0)
    res = eng.search(_rows(rng, 2, DataType.FLOAT32), k=5, filter_mask=fresh)
    assert (res.indices % 2 == 0).all()


@pytest.mark.parametrize("seed", range(6))
def test_mutation_sequence_matches_reference(tmp_path, seed):
    """A random sequence of appends (some within capacity, some across),
    deletes and searches at random k on an f32 space with an ID column, in
    the style of ``tests/test_fuzz_equivalence.py``: state and results equal
    to the reference's after every step, and to the numpy oracle."""
    rng = np.random.default_rng(100 + seed)
    n0 = int(rng.integers(1, 60))
    data = _rows(rng, n0, DataType.FLOAT32)
    ids = rng.permutation(10 * n0).astype(np.uint64)[:n0]
    metric = [L2, IP][seed % 2]
    path = _file(tmp_path, data, metric=metric, ids=ids)
    ref, port = _pair(path)
    eng, ref_eng = SearchEngine(port), JaxEngine(ref, backend="xla")
    rows_all, live, next_id = data, np.ones(n0, bool), 10 * n0
    for _ in range(12):
        op = rng.choice(["add", "delete", "search"])
        if op == "add":
            n = int(rng.integers(1, 40))
            new = _rows(rng, n, DataType.FLOAT32)
            nid = np.arange(next_id, next_id + n, dtype=np.uint64)
            next_id += n
            reserve = float(rng.choice([1.25, 1.5, 2.0]))
            ref.add_rows(new, ids=nid, reserve=reserve)
            port.add_rows(new, ids=nid, reserve=reserve)
            rows_all = np.concatenate([rows_all, new])
            live = np.concatenate([live, np.ones(n, bool)])
        elif op == "delete" and live.any():
            victims = rng.choice(np.flatnonzero(live), min(3, int(live.sum())),
                                 replace=False)
            ref.delete_rows(rows=victims)
            port.delete_rows(rows=victims)
            live[victims] = False
        _assert_same_state(ref, port)
        q = _rows(rng, int(rng.integers(1, 6)), DataType.FLOAT32)
        k = int(rng.integers(1, len(rows_all) + 3))
        a = eng.search(q, k=k)
        _assert_results(a, ref_eng.search(q, k=k))
        _, oi = numpy_oracle(q, rows_all, min(k, int(live.sum())), metric,
                             valid_mask=live.astype(np.float32))
        found = a.indices[:, : oi.shape[1]]
        np.testing.assert_array_equal(
            exact_scores(q, rows_all, metric)[np.arange(len(q))[:, None], found],
            exact_scores(q, rows_all, metric)[np.arange(len(q))[:, None], oi])


def test_grown_space_ids_and_persisted_append(tmp_path):
    """Ids on a grown space (``tests/test_vector_ids.py``'s search ids) and
    the append persisted through ``builder_from_reader``
    (``tests/test_append.py``): the reopened file serves the live engine's
    answers."""
    rng = np.random.default_rng(10)
    data = _rows(rng, 30, DataType.FLOAT32)
    ids = np.arange(30, dtype=np.uint64) * 7 + 1
    path = _file(tmp_path, data, ids=ids)
    _, port = _pair(path)
    new = _rows(rng, 25, DataType.FLOAT32)
    new_ids = np.arange(25, dtype=np.uint64) + 5000
    port.add_rows(new, ids=new_ids)
    port.delete_rows(ids=[8, 5003])
    q = _rows(rng, 6, DataType.FLOAT32)
    live_res = SearchEngine(port).search(q, k=8)
    all_ids = np.concatenate([ids, new_ids])
    ok = live_res.indices >= 0
    np.testing.assert_array_equal(live_res.ids[ok], all_ids[live_res.indices[ok]])
    b = builder_from_reader(PortReader.open(path))
    b.add_vectors("e", new, ids=new_ids)
    out = tmp_path / "appended.mvt"
    b.build().save(out)
    sp = PortReader.open(out).vector_space("e")
    eng = SearchEngine(sp, device="cpu")
    eng.space.delete_rows(ids=[8, 5003])
    res = eng.search(q, k=8)
    np.testing.assert_array_equal(res.ids, live_res.ids)
    np.testing.assert_array_equal(res.scores, live_res.scores)


# ------------------------------------------------------------ snapshots ---


def _planted(rng, n=64):
    """Integer rows where each query has more than one margin of rows tied
    at its k-th score, so "high_verified" cannot certify and falls back."""
    base = _rows(rng, n // 4, DataType.FLOAT32)
    return np.repeat(base, 4, axis=0)


@pytest.mark.parametrize("precision", ["highest", "high_verified"])
def test_launch_before_growth_finalizes_on_its_snapshot(tmp_path, precision):
    """``_launch``, then an append that crosses capacity (rows of 4× the
    largest norm, which widen the certificate's norm range), then
    ``_finalize``: the result is a search of the old snapshot, including
    the ``high_verified`` fallback's re-run and the IDs."""
    rng = np.random.default_rng(11)
    data = _planted(rng)
    ids = np.arange(len(data), dtype=np.uint64) + 77
    path = _file(tmp_path, data, ids=ids)
    _, port = _pair(path, precision)
    _, old = _pair(path, precision)
    eng = SearchEngine(port, verify_margin=1)
    q = data[:6] + 1
    pending = eng._launch(q, 5)
    snap = port.snapshot
    big = 4 * data[np.argmax((data ** 2).sum(1))][None].repeat(200, 0)
    port.add_rows(big, ids=np.arange(200, dtype=np.uint64) + 10_000)
    assert port.padded_rows > snap.padded_rows and port.snapshot is not snap
    got = eng._finalize(pending, 5)
    want = SearchEngine(old, verify_margin=1).search(q, k=5)
    _assert_results(got, want)
    if precision == "high_verified":
        assert eng.verify_stats["fallbacks"] > 0
    fresh = eng.search(q, k=5)  # a new launch reads the new snapshot
    rows = np.concatenate([data, big])
    _, oi = numpy_oracle(q, rows, 5, L2)
    np.testing.assert_array_equal(exact_scores(q, rows, L2)[
        np.arange(6)[:, None], fresh.indices], exact_scores(q, rows, L2)[
        np.arange(6)[:, None], oi])


def _writer_run(port, engine, pipeline, chunks=8, chunk_rows=40, clients=6,
                requests=120):
    """A writer appends ``chunks`` chunks (crossing capacity) and deletes a
    few rows after each while client threads search through a
    MicroBatcher. Returns the answers with what each was checked against."""
    rng = np.random.default_rng(12)
    deleted_at: list[tuple[float, np.ndarray]] = []  # (time done, rows)
    stop = threading.Event()
    errors: list[BaseException] = []
    answers = []
    lock = threading.Lock()
    next_id = [10**6]

    def writer():
        try:
            for _ in range(chunks):
                rows = _rows(rng, chunk_rows, DataType.FLOAT32)
                nid = np.arange(next_id[0], next_id[0] + chunk_rows, dtype=np.uint64)
                next_id[0] += chunk_rows
                port.add_rows(rows, ids=nid)
                victims = rng.choice(port.num_valid, 3, replace=False)
                port.delete_rows(rows=victims)
                deleted_at.append((time.monotonic(), victims))
                time.sleep(0.002)
        except BaseException as e:  # noqa: BLE001
            errors.append(e)
        finally:
            stop.set()

    with MicroBatcher(engine, k=5, max_batch=16, max_wait_ms=1.0,
                      pipeline=pipeline) as mb:
        def client(c):
            crng = np.random.default_rng(1000 + c)
            try:
                for _ in range(requests // clients):
                    q = _rows(crng, 1, DataType.FLOAT32)
                    t0 = time.monotonic()
                    res = mb.submit(q).result(timeout=60)
                    with lock:
                        answers.append((t0, res, port.num_valid))
            except BaseException as e:  # noqa: BLE001
                errors.append(e)

        threads = [threading.Thread(target=client, args=(c,)) for c in range(clients)]
        w = threading.Thread(target=writer)
        for t in threads + [w]:
            t.start()
        for t in threads + [w]:
            t.join(timeout=120)
    assert not errors, errors
    return answers, deleted_at


@pytest.mark.parametrize("pipeline", [False, True], ids=["serial", "pipelined"])
def test_batcher_under_a_concurrent_writer(tmp_path, pipeline):
    """Every answer lies below the row count published when it returned,
    holds no row deleted before its submit, and carries its rows' ids; after
    the writer stops, an answer equals the plain version's."""
    rng = np.random.default_rng(13)
    data = _rows(rng, 50, DataType.FLOAT32)
    ids = np.arange(50, dtype=np.uint64) + 1
    path = _file(tmp_path, data, ids=ids)
    _, port = _pair(path)
    eng = SearchEngine(port)
    answers, deleted_at = _writer_run(port, eng, pipeline)
    assert answers and port.num_valid == 50 + 8 * 40
    final_ids = port.host_ids
    for t0, res, nv_after in answers:
        rows = res.indices[res.indices >= 0]
        assert (rows < nv_after).all()
        gone = [v for t, v in deleted_at if t < t0]
        if gone:
            assert not np.isin(rows, np.concatenate(gone)).any()
        np.testing.assert_array_equal(res.ids[res.indices >= 0], final_ids[rows])
    q = _rows(rng, 4, DataType.FLOAT32)
    live = port.valid_mask[: port.num_valid].numpy()
    rows_all = port.data[: port.num_valid, :D].numpy()
    got = eng.search(q, k=9)
    os_, oi = numpy_oracle(q, rows_all, 9, L2, valid_mask=live)
    np.testing.assert_array_equal(got.scores, os_)


# ------------------------------------------------------------------- PQ ---


def _pq_pair(metric, packed4, seed=4, n=300):
    """A JAX PQIndex over integer rows with integer codebooks and ids, and
    the port's from its state."""
    rng = np.random.default_rng(seed)
    centers = rng.integers(0, 8, (6, D)).astype(np.float32) * 40
    data = (centers[rng.integers(0, 6, n)] + rng.integers(-3, 4, (n, D))).astype(np.float32)
    books = np.rint(jax_pq.train_pq(data, m=4, ksub=16, iters=3, seed=seed))
    ids = np.arange(n, dtype=np.uint64) * 3 + 11
    ref = jax_pq.PQIndex.build(data, metric, codebooks=books, pack4=packed4, ids=ids)
    state = {name: None if getattr(ref, name) is None else np.asarray(getattr(ref, name))
             for name in ("codebooks", "codes", "recon_norms", "db", "db_norms", "valid")}
    state.update(metric=int(metric), dim=ref.dim, num_vectors=ref.num_vectors,
                 packed4=ref.packed4, host_ids=ref.host_ids)
    return ref, PQIndex.from_state(state, device="cpu"), data, centers, rng


def _pq_state_equal(ref, port):
    assert port.num_vectors == ref.num_vectors
    for name in ("codes", "recon_norms", "db", "db_norms", "valid"):
        a, b = getattr(port, name), getattr(ref, name)
        assert (a is None) == (b is None), name
        if a is not None:
            assert a.shape[0] == b.shape[0], name  # the same capacity
            np.testing.assert_array_equal(a.numpy(), np.asarray(b).astype(a.numpy().dtype),
                                          err_msg=name)
    np.testing.assert_array_equal(port.host_ids, ref.host_ids)


@pytest.mark.parametrize("packed4", [False, True], ids=["pq8", "pq4"])
def test_pq_add_and_delete_rows_match_reference(packed4):
    """Appends encoded with the trained codebooks (crossing capacity), then
    deletes: the planes, the capacity and the searches (ADC alone and with
    a re-rank against the grown originals) equal the reference's."""
    ref, port, data, centers, rng = _pq_pair(L2, packed4)
    q = (data[rng.integers(0, len(data), 6)] + rng.integers(-9, 10, (6, D))).astype(np.float32)
    for step, n in enumerate((20, 150, 5)):
        new = (centers[rng.integers(0, 6, n)] + rng.integers(-3, 4, (n, D))).astype(np.float32)
        nid = np.arange(n, dtype=np.uint64) + 10_000 * (step + 1)
        ref.add_rows(new, ids=nid)
        port.add_rows(new, ids=nid)
        _pq_state_equal(ref, port)
        for rerank in (0, 60):
            a = port.search(q, k=10, rerank=rerank)
            b = ref.search(q, k=10, rerank=rerank, backend="xla")
            _assert_results(a, b)
        victims = a.indices[:, 0]
        ref.delete_rows(victims)
        port.delete_rows(victims)
        _pq_state_equal(ref, port)
        assert not np.isin(port.search(q, k=10, rerank=60).indices, victims).any()
    with pytest.raises(IndexOutOfBoundsError):
        port.delete_rows([port.num_vectors])


def test_pq_add_rows_capacity_growth():
    """``tests/test_online_mutation.py::test_pq_add_rows_capacity_growth``:
    128-row capacity steps, as the reference takes them."""
    rng = np.random.default_rng(14)
    data = rng.standard_normal((256, 8)).astype(np.float32)
    books = jax_pq.train_pq(data, m=4, ksub=16, iters=3)
    ref = jax_pq.PQIndex.build(data, L2, codebooks=books, keep_vectors=False)
    port = PQIndex.build(data, L2, codebooks=books, keep_vectors=False, device="cpu")
    for n in (1, 4, 200, 1):
        new = rng.standard_normal((n, 8)).astype(np.float32)
        ref.add_rows(new)
        port.add_rows(new)
        assert port.codes.shape[0] == ref.codes.shape[0]
        assert port.num_vectors == ref.num_vectors
        np.testing.assert_array_equal(port.codes.numpy(), np.asarray(ref.codes))


def test_pq_int8_lut_route_unchanged_after_growth():
    """The int8 LUT keeps its route after growth (it depends on ksub, m and
    the code columns, which an append does not change), and its plain
    version answers the grown index as the reference's Pallas kernel in
    interpret mode does."""
    ref, port, data, centers, rng = _pq_pair(L2, True, n=200)
    route = int8_lut_route(port.ksub, port.m, port.codes.shape[1])
    new = (centers[rng.integers(0, 6, 100)] + rng.integers(-3, 4, (100, D))).astype(np.float32)
    nid = np.arange(100, dtype=np.uint64) + 50_000
    ref.add_rows(new, ids=nid)
    port.add_rows(new, ids=nid)
    assert int8_lut_route(port.ksub, port.m, port.codes.shape[1]) == route
    q = new[:4] + 1
    a = port.search(q, k=5, int8_lut=True)
    b = ref.search(q, k=5, int8_lut=True, backend="pallas")
    np.testing.assert_array_equal(a.indices, b.indices)
    np.testing.assert_array_equal(a.ids, b.ids)


# ------------------------------------------------------------------ IVF ---


def _ivf_pair(metric, seed=3, n=400, c=8):
    rng = np.random.default_rng(seed)
    centers = rng.integers(0, 8, (c, D)).astype(np.float32) * 30
    which = rng.integers(0, c, n)
    data = (centers[which] + rng.integers(-3, 4, (n, D))).astype(np.float32)
    cents, _ = jax_ivf.train_kmeans(data, c, iters=4, seed=seed)
    cents = np.rint(cents).astype(np.float32)
    d2 = (cents.astype(np.float64) ** 2).sum(1)[None, :] - 2.0 * (
        data.astype(np.float64) @ cents.T)
    assign = np.argmin(d2, axis=1).astype(np.int32)
    norms = (data.astype(np.float64) ** 2).sum(1).astype(np.float32)
    ref = jax_ivf.IVFIndex.build(data, norms, metric, c, centroids=cents,
                                 assignments=assign)
    port = IVFIndex.build(data, norms, metric, c, centroids=cents,
                          assignments=assign, device="cpu")
    return ref, port, data, centers, rng


def _ivf_state_equal(ref, port):
    assert port.num_vectors == ref.num_vectors and port.num_buckets == ref.num_buckets
    for name in ("buckets", "bucket_ids", "bucket_norms", "probe_centroids"):
        np.testing.assert_array_equal(getattr(port, name).numpy(),
                                      np.asarray(getattr(ref, name)), err_msg=name)
    for name in ("cells", "fill", "row_bucket", "row_slot"):
        np.testing.assert_array_equal(getattr(port, name), getattr(ref, name),
                                      err_msg=name)


@pytest.mark.parametrize("metric", [L2, IP])
def test_ivf_add_rows_overflow_matches_reference(metric):
    """Appends into existing tail slots, then one that overflows a cluster
    into new buckets (``test_ivf_append_overflow_allocates_buckets``), then
    deletes: the layout and the searches (full and partial probe) equal the
    reference's."""
    ref, port, data, centers, rng = _ivf_pair(metric)
    q = (data[rng.integers(0, len(data), 5)] + rng.integers(-9, 10, (5, D))).astype(np.float32)
    nb0 = port.num_buckets
    for n, around in ((5, None), (300, 2), (7, None)):
        which = rng.integers(0, len(centers), n) if around is None else np.full(n, around)
        new = (centers[which] + rng.integers(-3, 4, (n, D))).astype(np.float32)
        ref.add_rows(new)
        port.add_rows(new)
        _ivf_state_equal(ref, port)
        for nprobe in (2, port.num_buckets):
            _assert_results(port.search(q, k=10, nprobe=nprobe),
                            ref.search(q, k=10, nprobe=nprobe))
        if metric == L2:  # a row is its own nearest neighbour
            found = port.search(new[:3], k=1, nprobe=port.num_buckets).indices[:, 0]
            assert (found >= len(data)).all()
    assert port.num_buckets > nb0
    ref.delete_rows([0, len(data) + 4])
    port.delete_rows([0, len(data) + 4])
    _ivf_state_equal(ref, port)
    _assert_results(port.search(q, k=10, nprobe=4), ref.search(q, k=10, nprobe=4))
    with pytest.raises(IndexOutOfBoundsError):
        port.delete_rows([port.num_vectors])


# --------------------------------------------------------------- IVF-PQ ---


def _ivfpq_pair(packed4, seed=3, n=500, c=8):
    """Integer rows, centroids and codebooks (the construction of
    ``tests/test_torch_ivfpq.py``), ids, and the port's index from the
    reference's state."""
    rng = np.random.default_rng(seed)
    centers = rng.integers(0, 8, (c, D)).astype(np.float32) * 30
    which = rng.integers(0, c, n)
    data = (centers[which] + rng.integers(-3, 4, (n, D))).astype(np.float32)
    cents, _ = jax_ivf.train_kmeans(data, c, iters=4, seed=seed)
    cents = np.rint(cents).astype(np.float32)
    d2 = (cents.astype(np.float64) ** 2).sum(1)[None, :] - 2.0 * (
        data.astype(np.float64) @ cents.T)
    assign = np.argmin(d2, axis=1).astype(np.int32)
    res = data - cents[assign]
    books = np.rint(jax_pq.train_pq(res, m=4, ksub=16, iters=3, seed=seed)).astype(np.float32)
    codes = jax_pq.encode_pq(res, books)
    ids = np.arange(n, dtype=np.uint64) * 5 + 9
    ref = jax_ivfpq.IVFPQIndex.build(data, L2, c, centroids=cents, assignments=assign,
                                     codebooks=books, codes=codes, pack4=packed4,
                                     ids=ids)
    from test_torch_ivfpq import state_of

    return ref, IVFPQIndex.from_state(state_of(ref), device="cpu"), data, centers, rng


def _ivfpq_state_equal(ref, port):
    assert port.num_vectors == ref.num_vectors and port.num_buckets == ref.num_buckets
    for name in ("buckets", "bucket_ids", "bucket_norms", "probe_centroids",
                 "codes_row", "rnorms_row", "row_bucket", "row_valid", "db", "db_norms"):
        a, b = getattr(port, name).numpy(), np.asarray(getattr(ref, name))
        assert a.shape == b.shape, name  # the same capacity
        np.testing.assert_array_equal(a, b, err_msg=name)
    for name in ("cells", "fill", "row_bucket_host", "row_slot_host", "host_ids"):
        np.testing.assert_array_equal(getattr(port, name), getattr(ref, name),
                                      err_msg=name)
    np.testing.assert_array_equal(port.bucket_fill.numpy(), port.fill)


@pytest.mark.parametrize("packed4", [False, True], ids=["u8", "packed4"])
def test_ivfpq_add_rows_both_modes_match_reference(packed4):
    """Appends drawn around one centroid overflow its cluster into new
    buckets; both modes (the scan with the bucket bias, widened to the new
    bucket count, and the probe) return the appended rows, identical to the
    reference's same mode; then deletes, ``rebuild()`` and another append."""
    ref, port, data, centers, rng = _ivfpq_pair(packed4)
    nb0 = port.num_buckets
    new = (centers[1] + rng.integers(-3, 4, (260, D))).astype(np.float32)
    nid = np.arange(260, dtype=np.uint64) + 90_000
    ref.add_rows(new, ids=nid)
    port.add_rows(new, ids=nid)
    assert port.num_buckets > nb0
    _ivfpq_state_equal(ref, port)
    q = np.concatenate([new[:3], data[:3]]) + 1
    nprobe = 3

    def both_modes():
        for mode in ("scan", "probe"):
            for rerank in (0, 40):
                a = port.search(q, k=8, nprobe=nprobe, rerank=rerank, mode=mode,
                                exact_lut=True)
                b = ref.search(q, k=8, nprobe=nprobe, rerank=rerank, mode=mode,
                               exact_lut=True, interpret=True)
                _assert_results(a, b)
        return a

    res = both_modes()
    assert (res.indices[:3] >= len(data)).any()  # appended rows found
    placed_new = port.row_bucket_host[len(data):] >= nb0
    assert placed_new.any()  # some went to new buckets
    ref.delete_rows([1, len(data) + 2])
    port.delete_rows([1, len(data) + 2])
    _ivfpq_state_equal(ref, port)
    both_modes()
    ref.rebuild()
    port.rebuild()
    _ivfpq_state_equal(ref, port)
    both_modes()
    more = (centers[rng.integers(0, len(centers), 9)] + 1).astype(np.float32)
    ref.add_rows(more, ids=np.arange(9, dtype=np.uint64) + 95_000)
    port.add_rows(more, ids=np.arange(9, dtype=np.uint64) + 95_000)
    _ivfpq_state_equal(ref, port)
    both_modes()


def test_ivfpq_incremental_append_keeps_capacity_and_modes_agree():
    """``test_ivfpq_incremental_append_no_layout_rebuild``: a small append
    makes no new bucket, fits the row-order capacity after one growth step
    (same tensors), and both modes agree on it."""
    ref, port, data, centers, rng = _ivfpq_pair(False, n=256)
    nb0 = port.num_buckets
    new = (centers[rng.integers(0, len(centers), 8)] + 2).astype(np.float32)
    nid = np.arange(8, dtype=np.uint64) + 70_000
    port.add_rows(new, ids=nid)
    assert port.num_buckets == nb0 and port.num_vectors == 264
    ptr = port.codes_row.data_ptr()
    port.add_rows(new + 1, ids=nid + 8)
    assert port.codes_row.data_ptr() == ptr  # within capacity: in place
    n = port.num_buckets
    r_probe = port.search(new[:2], k=3, nprobe=n, mode="probe", rerank=20)
    r_scan = port.search(new[:2], k=3, nprobe=n, mode="scan", rerank=20)
    np.testing.assert_array_equal(r_probe.indices, r_scan.indices)
    assert r_probe.indices[0, 0] == 256


def test_scans_read_the_logical_rows_not_the_capacity(tmp_path, monkeypatch):
    """After a growth step the tensors hold more rows than ``num_valid``;
    the dense scan and the PQ and IVF-PQ scans are handed only the logical
    rows (views), so their time follows the rows, not the capacity."""
    import metrovector_tpu_torch.engine as eng_mod
    import metrovector_tpu_torch.index.ivfpq as ivfpq_mod
    import metrovector_tpu_torch.index.pq as pq_mod

    seen = []

    def spy(fn):
        def wrapped(q, rows, *args, **kw):
            seen.append(int(rows.shape[0]))
            return fn(q, rows, *args, **kw)
        return wrapped

    rng = np.random.default_rng(15)
    path = _file(tmp_path, _rows(rng, 37, DataType.FLOAT32))
    _, port = _pair(path)
    port.add_rows(_rows(rng, 30, DataType.FLOAT32))
    assert port.padded_rows > port.num_valid
    monkeypatch.setattr(eng_mod, "fused_topk", spy(eng_mod.fused_topk))
    SearchEngine(port).search(_rows(rng, 2, DataType.FLOAT32), k=3,
                              filter_mask=np.ones(port.num_valid, bool))
    _, pq_port, data, centers, _ = _pq_pair(L2, False, n=200)
    pq_port.add_rows(data[:5] + 1, ids=np.arange(5, dtype=np.uint64) + 80_000)
    monkeypatch.setattr(pq_mod, "fused_adc_topk", spy(pq_mod.fused_adc_topk))
    pq_port.search(data[:2], k=3)
    _, ivf_port, data, _, _ = _ivfpq_pair(False, n=256)
    ivf_port.add_rows(data[:5] + 1, ids=np.arange(5, dtype=np.uint64) + 80_000)
    monkeypatch.setattr(ivfpq_mod, "fused_adc_topk", spy(ivfpq_mod.fused_adc_topk))
    ivf_port.search(data[:2], k=3, mode="scan")
    assert seen == [67, 205, 261]
    assert pq_port.codes.shape[0] > 205 and ivf_port.codes_row.shape[0] > 261
