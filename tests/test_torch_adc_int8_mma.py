"""K2's int8 LUT on CUDA, checked on the CPU without a kernel: the two
routes of ``ops/adc_kernel.py::int8_lut_route``.

* ksub ≤ 16: ``csrc/adc_int8_mma_kernel.cu`` sums the LUT as the int8
  tensor-core product of the rows' one-hot codes and the LUT. The tests
  emulate each consumer lane's A registers as the kernel builds them from a
  stage of codes (:func:`a_fragment`) and check that they reassemble the
  exact one-hot; then score with that one-hot's int32 product in the
  kernel's formula order and hold the result to the JAX package's Pallas
  ``fused_adc_topk(int8_lut=True)`` in interpret mode: bit for bit for L2
  and IP (integer data, where both packages' f32 LUTs agree exactly; where
  XLA computes the scale's division by 127 as a multiply by f32(1/127) and
  the two round apart, the emulation takes XLA's scale), and for cosine
  indices identical and scores within 4 f32 ulp (the reference's
  ``rsqrt``), as ``tests/test_torch_adc_int8.py`` holds the plain version;
  against the port's plain version bit for bit on every metric.
* ksub > 16, and a pq4 LUT too large for the product:
  ``csrc/adc_scan.cuh``'s lookup scan adds the entries biased to ``e +
  128`` two queries a 32-bit word and widens the 16-bit lanes every 256
  subspaces (:func:`lane_sums`, over unpacked and nibble-packed rows):
  exact at the extremes, m = 257 and 512 included.
* The routing sends every m to a kernel whose plan fits, and the plan of
  the tensor-core scan (``int8_mma_shape``) stays within the 227 KB a
  block may use at every batch up to 4,096 and every k up to 1,024 for the
  suite's (m, ksub) pairs, as the lookup scan's does on its route.
"""

import numpy as np
import pytest
import torch

from metrovector_tpu import DistanceMetric
from metrovector_tpu.index.pq import pack_codes4
from metrovector_tpu.ops.adc_kernel import fused_adc_topk as jax_fused_adc_topk
from metrovector_tpu_torch.ops import adc_kernel as ak
from metrovector_tpu_torch.ops import topk_kernel as tk
from metrovector_tpu_torch.ops.adc_kernel import (
    adc_lut, fused_adc_topk, fused_adc_topk_reference, quantize_lut,
)

from _torch_parity import METRICS, assert_topk_match, unit_rows

COS = DistanceMetric.COSINE
ROWS = 64  # a stage: the wgmma M


def _ld4(stage: np.ndarray, off: int) -> int:
    """``ld4``: the two aligned words around ``off``, funnel-shifted."""
    w = stage[off & ~3: (off & ~3) + 8].view("<u4")
    return int(((int(w[1]) << 32 | int(w[0])) >> (8 * (off & 3))) & 0xFFFFFFFF)


def _prmt(x: int, y: int, sel: int) -> int:
    """``__byte_perm``: byte i of the result is byte (sel >> 4 i) & 7 of the
    eight bytes of y:x."""
    src = (y << 32 | x).to_bytes(8, "little")
    return int.from_bytes(bytes(src[(sel >> (4 * i)) & 7] for i in range(4)), "little")


def _shift_bytes(c8: int, kt: int) -> int:
    """``shift_bytes``: (kt - c8) XOR 0x80808080 in 32 bits."""
    return ((kt - c8) & 0xFFFFFFFF) ^ 0x80808080


def _onehot_reg(v: int, u: int) -> int:
    """``onehot_reg``: PTX ``shr.b32`` of 0x80000000 by byte u of v, the
    amount clamped to 32."""
    amount = _prmt(v, 0, 0x4440 + u)
    return 0 if amount >= 32 else 0x80000000 >> amount


def a_fragment(stage: np.ndarray, cols: int, packed: bool, nch: int) -> np.ndarray:
    """The A operand of every k step as the kernel's consumer lanes build it
    (``onehot_chunk``), reassembled by the m16n8k32 fragment layout of each
    warp's 16 rows into ``[64, 128 nch]`` int8 (columns 16 j + c: subspace
    j, code c)."""
    out = np.zeros((ROWS, 128 * nch), np.int8)
    for warp in range(4):
        for lane in range(32):
            g, t = lane >> 2, lane & 3
            r_lo = 16 * warp + g
            offs = (r_lo * cols, (r_lo + 8) * cols)
            kt = (159 + 32 * t) * 0x01010101
            for c in range(nch):
                even, odd = [], []
                for off in offs:
                    if packed:
                        w = _ld4(stage, off + 4 * c)
                        even.append(_shift_bytes((w << 3) & 0x78787878, kt))
                        odd.append(_shift_bytes((w >> 1) & 0x78787878, kt))
                    else:
                        lo, hi = _ld4(stage, off + 8 * c), _ld4(stage, off + 8 * c + 4)
                        even.append(_shift_bytes((_prmt(lo, hi, 0x6420) << 3) & 0x78787878,
                                                 kt))
                        odd.append(_shift_bytes((_prmt(lo, hi, 0x7531) << 3) & 0x78787878,
                                                kt))
                for kk in range(4):
                    regs = (_onehot_reg(even[0], kk), _onehot_reg(even[1], kk),
                            _onehot_reg(odd[0], kk), _onehot_reg(odd[1], kk))
                    for i, reg in enumerate(regs):
                        row = r_lo + 8 * (i & 1)
                        col = 128 * c + 32 * kk + 16 * (i >> 1) + 4 * t
                        out[row, col:col + 4] = np.frombuffer(
                            reg.to_bytes(4, "little"), np.int8)
    return out


def _stage(codes: np.ndarray, packed: bool, rng) -> tuple[np.ndarray, int]:
    """A stage as the producer lays it out: the rows' stored codes back to
    back, then the 32 bytes of slack and the norms (random here: the slack
    is uninitialized in the kernel). Returns (bytes, cols)."""
    stored = pack_codes4(codes) if packed else codes
    cols = stored.shape[1]
    body = np.ascontiguousarray(stored).reshape(-1)
    size = -(-ROWS * cols // 16) * 16 + 32 + 4 * ROWS
    stage = rng.integers(0, 256, size).astype(np.uint8)
    stage[:body.size] = body
    return stage, cols


@pytest.mark.parametrize("m", [23, 24, 32, 1])
@pytest.mark.parametrize("ksub", [8, 16])
@pytest.mark.parametrize("packed", [True, False], ids=["packed4", "u8"])
def test_a_fragment_reassembles_one_hot(packed, ksub, m):
    """Every lane's registers put a 1 at column 16 j + code_j of each of its
    rows' subspaces j < m and nowhere else in them; the padded subspaces
    (j ≥ m, up to a whole pair of chunks, read from the next row, the slack
    or the norms) hold at most one 1 each, where the LUT's columns are
    zero."""
    rng = np.random.default_rng(m * ksub + packed)
    codes = rng.integers(0, ksub, (ROWS, m)).astype(np.uint8)
    codes[0] = ksub - 1
    codes[1] = 0
    stage, cols = _stage(codes, packed, rng)
    nch = ak._mma_chunks(m)
    got = a_fragment(stage, cols, packed, nch).reshape(ROWS, 8 * nch, 16)
    want = np.zeros((ROWS, m, 16), np.int8)
    np.put_along_axis(want, codes[:, :, None].astype(np.int64), 1, axis=2)
    np.testing.assert_array_equal(got[:, :m], want)
    assert set(np.unique(got)) <= {0, 1}
    assert (got[:, m:].sum(axis=2) <= 1).all()


def _lut16(lut8: np.ndarray, m: int, ksub: int) -> np.ndarray:
    """The kernel's B: each subspace widened to 16 columns with zeros, K
    padded with zero columns to whole pairs of chunks of 8 subspaces."""
    nq = lut8.shape[0]
    out = np.zeros((nq, 8 * ak._mma_chunks(m), 16), np.int32)
    out[:, :m, :ksub] = lut8.reshape(nq, m, ksub)
    return out.reshape(nq, -1)


def emulate_mma_scan(q, stored, books, rnorms, num_valid, k, metric, mask, packed,
                     recip_scale=False):
    """The tensor-core scan in plain numpy: per stage of 64 rows the one-hot
    of :func:`a_fragment` times the widened LUT in int32, then the kernel's
    epilogue, each step rounded in f32 (``f32(acc) * sq``, then ``2 s - n``
    or ``s * 1/sqrt(max(n, 1e-30))``), masks to -inf, and top-k by (score
    descending, row ascending). ``recip_scale``: the scale multiplied back
    is ``max|LUT| * f32(1/127)``, as XLA's CPU backend computes the
    reference's ``max|LUT| / 127``."""
    m, ksub, _ = books.shape
    rng = np.random.default_rng(0)
    lut = adc_lut(torch.from_numpy(q), torch.from_numpy(books), True)
    lut8, sq = (a.numpy() for a in quantize_lut(lut))
    if recip_scale:
        sq = np.maximum(np.abs(lut.numpy()).max(axis=1), np.float32(1e-30)) * np.float32(1 / 127)
    b = _lut16(lut8, m, ksub)
    codes = ak.unpack_nibbles(torch.from_numpy(stored), m).numpy() if packed else stored
    n = codes.shape[0]
    nch = ak._mma_chunks(m)
    acc = np.zeros((q.shape[0], n), np.int64)
    for r0 in range(0, n, ROWS):
        rows = codes[r0:r0 + ROWS]
        if rows.shape[0] < ROWS:  # the stage's stale rows: any codes
            rows = np.concatenate([rows, rng.integers(0, ksub, (ROWS - rows.shape[0], m))
                                   .astype(np.uint8)])
        stage, cols = _stage(rows, packed, rng)
        a = a_fragment(stage, cols, packed, nch).astype(np.int32)
        acc[:, r0:r0 + ROWS] = (b @ a.T)[:, :min(ROWS, n - r0)]
    assert np.abs(acc).max() < 2**31
    s = acc.astype(np.int32).astype(np.float32) * sq[:, None]
    nrm = rnorms[None, :]
    if DistanceMetric(metric) == DistanceMetric.L2:
        s = np.float32(2) * s - nrm
    elif DistanceMetric(metric) == COS:
        s = s * (np.float32(1) / np.sqrt(np.maximum(nrm, np.float32(1e-30))))
    live = np.arange(n) < num_valid
    if mask is not None:
        live &= mask != 0
    s = np.where(live[None], s, np.float32(-np.inf)).astype(np.float32)
    order = np.lexsort((np.broadcast_to(np.arange(n), s.shape), -s), axis=1)[:, :k]
    top_s = np.take_along_axis(s, order, axis=1)
    top_i = np.where(np.isfinite(top_s), order, -1).astype(np.int32)
    return top_s, top_i


N, DSUB, NQ = 300, 4, 5


def _inputs(kind, m, ksub, seed=7):
    rng = np.random.default_rng(seed)
    if kind == "integer":
        books = rng.integers(-8, 8, (m, ksub, DSUB)).astype(np.float32)
        q = rng.integers(-8, 8, (NQ, m * DSUB)).astype(np.float32)
    else:
        books = rng.standard_normal((m, ksub, DSUB)).astype(np.float32)
        q = rng.standard_normal((NQ, m * DSUB)).astype(np.float32)
    codes = rng.integers(0, ksub, (N, m)).astype(np.uint8)
    recon = np.concatenate([books[j][codes[:, j]] for j in range(m)], axis=1)
    rnorms = (recon.astype(np.float64) ** 2).sum(1).astype(np.float32)
    mask = (rng.random(N) > 0.3).astype(np.float32)
    return books, codes, rnorms, q, mask


CASES = [  # (m, ksub, packed4, masked)
    (4, 16, False, False),
    (5, 16, True, True),
    (9, 8, False, True),
    (8, 16, True, False),
]


@pytest.mark.parametrize("case", CASES, ids=lambda c: "-".join(map(str, c)))
@pytest.mark.parametrize("metric", METRICS)
def test_one_hot_product_matches_pallas_interpret(metric, case):
    m, ksub, packed, masked = case
    books, codes, rnorms, q, mask = _inputs("integer", m, ksub)
    if metric == COS:
        q = unit_rows(q)
    num_valid, vm, k = (N - 23, mask, 12) if masked else (N, None, 10)
    stored = pack_codes4(codes) if packed else codes
    got = emulate_mma_scan(q, stored, books, rnorms, num_valid, k, metric, vm, packed)
    want = jax_fused_adc_topk(q, stored, books, rnorms, np.int32(num_valid), k, metric,
                              valid_mask=vm, int8_lut=True, block_rows=128,
                              interpret=True, packed4=packed)
    want = tuple(np.asarray(a) for a in want)
    # XLA's CPU backend divides by 127 as a multiply by f32(1/127) where it
    # fuses the reference's quantization; the port rounds the quotient.
    # Where the two scales differ (m = 8 here) scores are one rounding of sq
    # apart, a few ulp.
    amax = np.abs(adc_lut(torch.from_numpy(q), torch.from_numpy(books), True)
                  .numpy()).max(axis=1)
    same_sq = np.array_equal(np.float32(amax) / np.float32(127),
                             np.float32(amax) * np.float32(1 / 127))
    if metric != COS:
        if not same_sq:  # the one-hot product with XLA's scale: the same bits
            got = emulate_mma_scan(q, stored, books, rnorms, num_valid, k, metric, vm,
                                   packed, recip_scale=True)
        assert_topk_match(got, want, exact=True)
        return
    np.testing.assert_array_equal(got[1], want[1])
    live = want[1] >= 0
    ulps = (np.abs(got[0][live].astype(np.float64) - want[0][live])
            / np.spacing(np.abs(want[0][live])))
    assert ulps.max(initial=0) <= 4


@pytest.mark.parametrize("kind", ["integer", "normal"])
@pytest.mark.parametrize("case", CASES, ids=lambda c: "-".join(map(str, c)))
@pytest.mark.parametrize("metric", METRICS)
def test_one_hot_product_matches_plain_version(metric, case, kind):
    """The emulated kernel and the port's plain version (lookups in
    ascending j) agree bit for bit on every metric, float data too: both
    sums are the same exact integers."""
    m, ksub, packed, masked = case
    books, codes, rnorms, q, mask = _inputs(kind, m, ksub, seed=11)
    if metric == COS:
        q = unit_rows(q)
    num_valid, vm, k = (N - 23, mask, 12) if masked else (N, None, 10)
    stored = pack_codes4(codes) if packed else codes
    got = emulate_mma_scan(q, stored, books, rnorms, num_valid, k, metric, vm, packed)
    t = torch.from_numpy
    want = fused_adc_topk(t(q), t(stored), t(books), t(rnorms), num_valid, k, metric,
                          None if vm is None else t(vm), packed4=packed, int8_lut=True)
    np.testing.assert_array_equal(got[1], want[1].numpy())
    np.testing.assert_array_equal(got[0], want[0].numpy())


def lane_sums(lut8: np.ndarray, codes: np.ndarray, ksub: int,
              packed: bool = False) -> np.ndarray:
    """``adc_scan.cuh::lut8_row`` for one row and the queries of ``lut8
    [QT, m ksub]`` in uint32 arithmetic: each entry staged as the byte e +
    128, a word's 4 bytes widened by ``__byte_perm`` into two words of two
    queries each (low lane the even query); the row's stored bytes (its
    ``codes``, nibble-packed if ``packed``) read in spans of the bytes of
    256 subspaces, after each of which the lanes go into int32 sums; minus
    128 m. Asserts that no lane passes 16 bits."""
    qt, mk = lut8.shape
    m = codes.size
    row = pack_codes4(codes[None])[0] if packed else codes
    per_byte = 2 if packed else 1
    span = ak.LANE_SPAN // per_byte
    biased = (lut8.astype(np.int64) + 128).astype(np.uint32)
    if qt % 2:
        biased = np.concatenate([biased, np.zeros((1, mk), np.uint32)])
    acc = np.full(qt, -128 * m, np.int64)
    for b0 in range(0, row.size, span):
        lanes = np.zeros(biased.shape[0] // 2, np.uint32)
        for b in range(b0, min(row.size, b0 + span)):
            for u in range(per_byte):
                j = per_byte * b + u
                if j >= m:
                    continue
                c = (int(row[b]) >> (4 * u)) & 15 if packed else int(row[b])
                e = biased[:, j * ksub + c]
                word = [int(e[i]) | int(e[i + 1]) << 8 for i in range(0, e.size, 2)]
                lanes = lanes + np.array([_prmt(w, 0, 0x4140) for w in word], np.uint32)
                assert (lanes & 0xFFFF).max() < 2**16 and (lanes >> 16).max() < 2**16
        lo, hi = (lanes & 0xFFFF).astype(np.int64), (lanes >> 16).astype(np.int64)
        assert lo.max() <= 255 * ak.LANE_SPAN and hi.max() <= 255 * ak.LANE_SPAN
        acc[0::2] += lo[:(qt + 1) // 2]
        acc[1::2] += hi[:qt // 2]
    return acc


def _check_lanes(ksub: int, packed: bool, fill: str, m: int, rng) -> None:
    for qt in (8, 5, 1):
        if fill == "random":
            lut8 = rng.integers(-127, 128, (qt, m * ksub)).astype(np.int8)
        else:
            lut8 = np.full((qt, m * ksub), int(fill), np.int8)
        codes = rng.integers(0, ksub, m).astype(np.uint8)
        want = np.array([lut8[q, np.arange(m) * ksub + codes].astype(np.int64).sum()
                         for q in range(qt)])
        np.testing.assert_array_equal(lane_sums(lut8, codes, ksub, packed), want)
        if fill != "random":
            assert (np.abs(want) == 127 * m).all()


@pytest.mark.parametrize("m", [1, 16, 255, 256, 257, 512, 513])
@pytest.mark.parametrize("fill", ["+127", "-127", "random"])
def test_biased_lanes_widen_exactly(fill, m):
    """At |sum| = 127 m (every entry +127 or -127) a lane holds 255·256 =
    65,280 or 256 before widening: the int32 sums come out exact, for
    m past one widening (257) and past two (512, 513), for 8 queries and
    for odd tiles (5, 1: the last word's high lane is empty)."""
    _check_lanes(256, False, fill, m, np.random.default_rng(m))


@pytest.mark.parametrize("m", [1, 31, 257, 288, 512, 513])
@pytest.mark.parametrize("fill", ["+127", "-127", "random"])
def test_biased_lanes_widen_exactly_packed(fill, m):
    """The lookup route of a pq4 LUT too large for the product (m = 288,
    513): nibble-packed rows, read 128 bytes (256 subspaces) a span, the
    high nibble of an odd m's last byte never read, give the int32 sums
    exactly at ksub = 16."""
    _check_lanes(16, True, fill, m, np.random.default_rng(m + 1))


def test_route_by_ksub():
    """One function routes: the tensor-core product up to ksub 16 (where
    nibble-packed codes live) while its 32 queries' LUT fits, lookups above
    and past that; at the suite's shapes by ksub alone."""
    for ksub in range(1, 257):
        for m, cols in ((32, 16), (24, 12), (12, 12), (32, 32)):
            if ksub > 16 and cols != m:
                continue
            assert ak.int8_lut_route(ksub, m, cols) == ("mma" if ksub <= 16 else "lookup")
    assert ak.INT8_MMA_KSUB == 16
    assert ak.int8_lut_route(16, 270, 135) == "mma"
    assert ak.int8_lut_route(16, 271, 136) == "lookup"
    assert ak.int8_lut_route(16, 199, 199) == "mma"
    assert ak.int8_lut_route(16, 200, 200) == "lookup"


@pytest.mark.parametrize("packed", [True, False])
@pytest.mark.parametrize("ksub", [8, 16])
def test_route_serves_every_m(ksub, packed):
    """Every m that the lookup scan ran before the product existed still
    runs: where the route picks the product, its plan exists at every
    batch and k (the lists in shared memory up to k = 1,024 where they
    fit); where it picks the lookups, their query tile of one fits."""
    ks = (1, 400, 1024, 1025, 100_000)
    for m in range(1, 4097):
        cols = (m + 1) // 2 if packed else m
        if ak.int8_lut_route(ksub, m, cols) == "mma":
            assert ak.int8_mma_fits(m, cols)
            if m % 17 == 0 or m < 40 or m > 180:
                for nq in (1, 32, 129, 256, 4096):
                    for k in ks:
                        assert ak.int8_mma_shape(nq, m, cols, k).smem <= ak.SMEM_LIMIT
        else:
            assert not ak.int8_mma_fits(m, cols)
            for k in ks:
                assert ak._fitting_tiles(m * ksub, k, False, k <= ak.SMEM_K, int8_lut=True)
    limit = 270 if packed else 199
    cols = (limit + 1) // 2 if packed else limit
    assert ak.int8_lut_route(ksub, limit, cols) == "mma"
    cols = (limit + 2) // 2 if packed else limit + 1
    assert ak.int8_lut_route(ksub, limit + 1, cols) == "lookup"


# benchmarks/suite.py's int8-LUT configurations and the edges the smoke
# runs: (m, ksub, packed4)
SUITE_PAIRS = [(32, 16, True), (24, 16, True), (12, 256, False), (16, 256, False),
               (32, 16, False), (23, 8, True), (23, 8, False), (257, 256, False),
               (270, 16, True), (199, 16, False), (288, 16, True), (200, 16, False)]
TILE_BATCHES = (1, 31, 32, 33, 64, 65, 127, 128, 129, 255, 256, 257, 4096)
EDGE_KS = (1, 10, 127, 128, 129, 400, 1000, 1024)


def _check_mma_shape(nq, m, cols, k):
    s = ak.int8_mma_shape(nq, m, cols, k)
    assert s.smem <= ak.SMEM_LIMIT, (nq, k)
    assert tk.MIN_STAGES <= s.stages <= ak.INT8_MMA_MAX_STAGES
    stage = ak._mma_stage_bytes(cols, s.nw)
    q_bytes = ak._mma_q_bytes(2 * s.nw, m)
    assert s.smem == tk._scan_smem(stage, s.stages, q_bytes, s.nw, 0 if s.big else k)
    assert s.big or k <= ak.SMEM_K
    if s.big and k <= ak.SMEM_K:  # no tile holds the lists in shared memory
        small = ak.INT8_MMA_NW[0]
        assert tk._scan_smem(ak._mma_stage_bytes(cols, small), tk.MIN_STAGES,
                             ak._mma_q_bytes(2 * small, m), small, k) > ak.SMEM_LIMIT
    if s.stages < ak.INT8_MMA_MAX_STAGES:
        assert s.smem + stage + 16 > ak.SMEM_LIMIT
    return s


@pytest.mark.parametrize("pair", SUITE_PAIRS, ids=lambda p: "-".join(map(str, p)))
def test_plan_shared_memory_every_batch_and_k(pair):
    """Every batch 1..4,096 at the edge ks and every k 1..1,024 at the tile
    edges: the tensor-core plan (ksub ≤ 16) fits 227 KB with a ring of at
    least two stages and its bytes are wgmma_scan.cuh::scan_smem's; the
    lookup scan (ksub > 16) has a query tile that fits."""
    m, ksub, packed = pair
    cols = (m + 1) // 2 if packed else m
    if ak.int8_lut_route(ksub, m, cols) == "lookup":
        for k in range(1, 1025):
            assert ak._fitting_tiles(m * ksub, k, False, k <= ak.SMEM_K, int8_lut=True)
            assert ak._fitting_tiles(m * ksub, k, False, False, int8_lut=True)
        return
    for nq in range(1, 4097):
        for k in EDGE_KS:
            _check_mma_shape(nq, m, cols, k)
    for nq in TILE_BATCHES:
        for k in range(1, 1025):
            _check_mma_shape(nq, m, cols, k)


@pytest.mark.parametrize("nq", TILE_BATCHES)
def test_plan_tile_follows_the_batch(nq):
    """At sift1m-pq4's shape (m = 32, 16 bytes a row) and k = 10 the tile
    is the least 2 NW that holds the batch up to 128 queries (batch 256
    takes two tiles), the lists in shared memory; at k = 400 the lists stay
    in shared memory beside a tile of 32 queries; past what fits (k =
    1024) they go to device memory and the tile follows the batch again."""
    want = min(max(-(-nq // 2), 16), 64)
    s = ak.int8_mma_shape(nq, 32, 16, 10)
    assert (s.nw, s.big) == (1 << (want - 1).bit_length(), False)
    assert ak.int8_mma_shape(nq, 32, 16, 400)[::3] == (16, False)
    s = ak.int8_mma_shape(nq, 32, 16, 1024)
    assert (s.nw, s.big) == (1 << (want - 1).bit_length(), True)


def test_plan_raises_past_the_resident_lut():
    """A LUT whose 32 queries do not fit shared memory has no product plan
    (asked for directly, it is refused with the reason); the route sends
    it to the lookup scan, which holds it."""
    ak.int8_mma_shape(32, 256, 128, 10)
    with pytest.raises(ValueError, match="do not fit"):
        ak.int8_mma_shape(32, 288, 144, 10)
    assert ak.int8_lut_route(16, 288, 144) == "lookup"
    assert ak._fitting_tiles(288 * 16, 10, False, True, int8_lut=True)


def test_cpu_int8_lut_launches_nothing():
    """On CPU tensors both routes run the plain version and count no
    launch."""
    books, codes, rnorms, q, _ = _inputs("integer", 4, 16)
    t = torch.from_numpy
    before = (fused_adc_topk.launches, fused_adc_topk.int8_launches,
              fused_adc_topk.int8_mma_launches)
    for bk, cd in ((books, codes), (np.repeat(books, 2, axis=1), codes * 2)):
        got = fused_adc_topk(t(q), t(cd), t(bk), t(rnorms), N, 7, DistanceMetric.L2,
                             int8_lut=True)
        want = fused_adc_topk_reference(t(q), t(cd), t(bk), t(rnorms), N, 7,
                                        DistanceMetric.L2, int8_lut=True)
        assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert (fused_adc_topk.launches, fused_adc_topk.int8_launches,
            fused_adc_topk.int8_mma_launches) == before

