"""The port's ADC scan (``fused_adc_topk`` on CPU tensors, i.e. its plain
version) against the JAX package: the Pallas ``fused_adc_topk`` run in
interpret mode, as the JAX package's own kernel tests run it, and the XLA
``_adc_search``.

Tolerance. Integer-valued queries and codebooks make every LUT entry and
every sum of m entries an exact f32 integer (and every entry exact in
bf16), so there L2/IP results must be identical. On float data with an f32
LUT each engine's sum of m entries errs by at most
(m−1)·2⁻²⁴·Σ_j max_c|LUT[q,j,c]|, so two engines differ by at most twice
that; L2 doubles the sum; cosine scales it by 1/‖x̂‖; and the epilogue adds
a rounding of the score itself. Indices must agree outside near-ties.

The IVF bucket-bias variant (``group_bias`` + ``group_ids``) is held to
the Pallas kernel's in interpret mode: identical on integer data (biases
are integers, also once rounded to bf16); on float data within the band
above plus the bias' share of the sum's rounding (4·m·2⁻²⁴·|bias|, doubled
for L2, scaled by 1/‖x̂‖ for cosine) and, with a bf16 LUT, 2⁻⁸ of the
largest score (a bf16 rounding of entries that f32 data does not make
exact).
"""

import numpy as np
import pytest
import torch

from metrovector_tpu import DistanceMetric
from metrovector_tpu.index.pq import _adc_search, pack_codes4
from metrovector_tpu.ops.adc_kernel import fused_adc_topk as jax_fused_adc_topk
from metrovector_tpu_torch.ops import adc_kernel
from metrovector_tpu_torch.ops.adc_kernel import fused_adc_topk

from _torch_parity import METRICS, assert_topk_match, exact_scores, unit_rows

N, DSUB, NQ = 300, 4, 5


def _pq_inputs(kind, m, ksub, seed=5):
    """(codebooks [m, ksub, DSUB], codes [N, m] u8, recon [N, D], recon
    norms [N], queries [NQ, D], mask [N])."""
    rng = np.random.default_rng(seed)
    if kind == "integer":
        books = rng.integers(0, 8, (m, ksub, DSUB)).astype(np.float32)
        q = rng.integers(0, 8, (NQ, m * DSUB)).astype(np.float32)
    else:
        books = rng.standard_normal((m, ksub, DSUB)).astype(np.float32)
        q = rng.standard_normal((NQ, m * DSUB)).astype(np.float32)
    codes = rng.integers(0, ksub, (N, m)).astype(np.uint8)
    recon = np.concatenate([books[j][codes[:, j]] for j in range(m)], axis=1)
    rnorms = (recon.astype(np.float64) ** 2).sum(1).astype(np.float32)
    mask = (rng.random(N) > 0.3).astype(np.float32)
    return books, codes, recon, rnorms, q, mask


def _band(q, books, recon, metric):
    """Per-query bound on |score_a − score_b| (module docstring)."""
    m = books.shape[0]
    lut = np.einsum("qmd,mkd->qmk", q.reshape(len(q), m, -1).astype(np.float64),
                    books.astype(np.float64))
    base = 2 * (m - 1) * 2.0**-24 * np.abs(lut).max(axis=2).sum(axis=1)
    norms = (recon.astype(np.float64) ** 2).sum(1)
    if DistanceMetric(metric) == DistanceMetric.L2:
        base = 2 * base
    elif DistanceMetric(metric) == DistanceMetric.COSINE:
        base = base / np.sqrt(max(norms.min(), 1e-30))
    top = np.abs(exact_scores(q, recon, metric)).max(axis=1)
    return base + 4 * 2.0**-24 * top


def _port(q, codes, books, rnorms, num_valid, k, metric, mask=None,
          exact_lut=True, packed4=False):
    before = fused_adc_topk.launches
    s, i = fused_adc_topk(
        torch.from_numpy(q), torch.from_numpy(codes), torch.from_numpy(books),
        torch.from_numpy(rnorms), num_valid, k, metric,
        None if mask is None else torch.from_numpy(mask),
        exact_lut=exact_lut, packed4=packed4,
    )
    assert fused_adc_topk.launches == before  # the plain path is no launch
    return s.numpy(), i.numpy()


CASES = [  # (kind, m, ksub, packed4, exact_lut, masked)
    ("integer", 4, 16, False, True, False),
    ("integer", 4, 16, True, False, True),
    ("integer", 5, 16, True, True, True),
    ("normal", 4, 32, False, True, True),
]


@pytest.mark.parametrize("case", CASES, ids=lambda c: "-".join(map(str, c)))
@pytest.mark.parametrize("metric", METRICS)
def test_cpu_path_matches_pallas_interpret(metric, case):
    kind, m, ksub, packed4, exact_lut, masked = case
    books, codes, recon, rnorms, q, mask = _pq_inputs(kind, m, ksub)
    if metric == DistanceMetric.COSINE:
        q = unit_rows(q)
    num_valid, vm, k = (N - 23, mask, 12) if masked else (N, None, 10)
    stored = pack_codes4(codes) if packed4 else codes
    got = _port(q, stored, books, rnorms, num_valid, k, metric, vm,
                exact_lut, packed4)
    want = jax_fused_adc_topk(q, stored, books, rnorms, np.int32(num_valid), k,
                              metric, valid_mask=vm, exact_lut=exact_lut,
                              block_rows=128, interpret=True, packed4=packed4)
    live = np.arange(N) < num_valid
    if vm is not None:
        live &= vm != 0
    assert_topk_match(
        got, tuple(np.asarray(a) for a in want),
        exact=kind == "integer" and metric != DistanceMetric.COSINE,
        tol=_band(q, books, recon, metric),
        scores64=exact_scores(q, recon, metric, live),
    )


@pytest.mark.parametrize("kind", ["integer", "normal"])
@pytest.mark.parametrize("metric", METRICS)
def test_cpu_path_matches_xla_adc_search(metric, kind):
    """Against ``_adc_search`` (raw queries, cosine through its query
    norm), with a mask, ``num_valid`` < N and k above the live rows. f32
    LUT only: the XLA CPU backend has no bf16 dot, so the bf16 LUT is held
    against the Pallas kernel above, on integer data. (On float data no f32
    band would hold for bf16 anyway: two f32 LUTs one ulp apart can round
    to bf16 values one bf16 ulp apart.)"""
    exact_lut = True
    books, codes, recon, rnorms, q, mask = _pq_inputs(kind, 5, 16, seed=6)
    qk = unit_rows(q) if metric == DistanceMetric.COSINE else q
    for num_valid, k in ((N, 10), (150, 120)):  # 150 rows, ~105 live < 120
        got = _port(qk, codes, books, rnorms, num_valid, k, metric, mask,
                    exact_lut)
        want = _adc_search(q, codes.astype(np.int32),
                           books.reshape(-1, DSUB), rnorms,
                           np.int32(num_valid), k, metric, valid_mask=mask,
                           block_rows=64, exact_lut=exact_lut)
        live = (np.arange(N) < num_valid) & (mask != 0)
        assert (got[1][:, live.sum():] == -1).all()
        assert_topk_match(
            got, tuple(np.asarray(a) for a in want),
            exact=kind == "integer" and metric != DistanceMetric.COSINE,
            tol=_band(q, books, recon, metric),
            scores64=exact_scores(q, recon, metric, live),
        )


@pytest.mark.parametrize("k", [257, 1000, 1024, 1025, 1200])
@pytest.mark.parametrize("packed4", [False, True])
def test_any_k_matches_pallas_interpret(k, packed4):
    """k past the old limit of 1024 up to k = N, on integer data: identical
    to the JAX kernel."""
    n = 1200
    rng = np.random.default_rng(8)
    books = rng.integers(0, 8, (4, 16, DSUB)).astype(np.float32)
    q = rng.integers(0, 8, (3, 4 * DSUB)).astype(np.float32)
    codes = rng.integers(0, 16, (n, 4)).astype(np.uint8)
    recon = np.concatenate([books[j][codes[:, j]] for j in range(4)], axis=1)
    rnorms = (recon.astype(np.float64) ** 2).sum(1).astype(np.float32)
    stored = pack_codes4(codes) if packed4 else codes
    got = _port(q, stored, books, rnorms, n, k, DistanceMetric.L2,
                packed4=packed4)
    want = jax_fused_adc_topk(q, stored, books, rnorms, np.int32(n), k,
                              DistanceMetric.L2, exact_lut=True, block_rows=128,
                              interpret=True, packed4=packed4)
    assert_topk_match(got, tuple(np.asarray(a) for a in want), exact=True)


def test_packed_and_unpacked_codes_agree():
    books, codes, _, rnorms, q, mask = _pq_inputs("normal", 5, 16)
    a = _port(q, codes, books, rnorms, N, 40, DistanceMetric.L2, mask)
    b = _port(q, pack_codes4(codes), books, rnorms, N, 40, DistanceMetric.L2,
              mask, packed4=True)
    np.testing.assert_array_equal(a[0], b[0])
    np.testing.assert_array_equal(a[1], b[1])


def test_reference_ties_go_to_lowest_row():
    """Rows with equal codes tie exactly; the lower row must come first,
    across the reference's row blocks too."""
    books, codes, _, rnorms, q, _ = _pq_inputs("integer", 2, 4)
    s, i = adc_kernel.fused_adc_topk_reference(
        torch.from_numpy(q), torch.from_numpy(codes), torch.from_numpy(books),
        torch.from_numpy(rnorms), N, 60, DistanceMetric.INNER_PRODUCT,
        exact_lut=True, block_rows=32)
    s, i = s.numpy(), i.numpy()
    same = s[:, 1:] == s[:, :-1]
    assert same.any() and (i[:, 1:][same] > i[:, :-1][same]).all()


def _bad(name):
    books = torch.zeros((4, 16, 2))
    codes = torch.zeros((10, 4), dtype=torch.uint8)
    q = torch.zeros((2, 8))
    packed4 = False
    if name == "dim_mismatch":
        q = torch.zeros((2, 6))
    elif name == "ksub_above_256":
        books = torch.zeros((4, 300, 2))
    elif name == "packed_ksub_above_16":
        books, packed4 = torch.zeros((4, 32, 2)), True
        codes = torch.zeros((10, 2), dtype=torch.uint8)
    elif name == "packed_columns":
        packed4 = True
    elif name == "code_columns":
        codes = torch.zeros((10, 3), dtype=torch.uint8)
    return q, codes, books, packed4


@pytest.mark.parametrize("name", ["dim_mismatch", "ksub_above_256",
                                  "packed_ksub_above_16", "packed_columns",
                                  "code_columns"])
def test_shape_checks_raise(name):
    q, codes, books, packed4 = _bad(name)
    with pytest.raises(ValueError):
        fused_adc_topk(q, codes, books, torch.zeros(10), 10, 3,
                       DistanceMetric.L2, packed4=packed4)


@pytest.mark.parametrize("name", ["k_zero", "k_above_limit", "codes_dtype",
                                  "norms_shape", "lut_too_big"])
def test_kernel_input_checks_raise(name):
    q, codes, books = torch.zeros((2, 8)), torch.zeros((10, 4), dtype=torch.uint8), \
        torch.zeros((4, 16, 2))
    norms, k = torch.zeros(10), 10
    if name == "k_zero":
        k = 0
    elif name == "k_above_limit":  # the limit is the corpus: k <= N
        k = 11
    elif name == "codes_dtype":
        codes = codes.to(torch.int32)
    elif name == "norms_shape":
        norms = torch.zeros(11)
    elif name == "lut_too_big":  # one query's f32 LUT above shared memory
        q, books = torch.zeros((2, 256)), torch.zeros((256, 256, 1))
        codes = torch.zeros((10, 256), dtype=torch.uint8)
    with pytest.raises(ValueError):
        adc_kernel._check_cuda(q, codes, books, norms, k, None, True)


def test_query_tile_fits_shared_memory():
    """Only tiles whose block fits in shared memory are offered (with its
    two score tiles, 32 queries of 4-bit m=32 codes and k=400 lists no
    longer do); the tile grows with the batch up to the largest with 3
    resident blocks per SM. The occupancies are an H100's for 4-bit m=32
    and 8-bit m=16 codes with an f32 LUT at k=400, as the launch-shape
    sweep read them (it skips QT = 1)."""
    assert adc_kernel._fitting_tiles(512, 400, True) == [1, 2, 4, 8, 16]
    assert adc_kernel._fitting_tiles(512, 400, True, lists_in_smem=False) == [
        1, 2, 4, 8, 16, 32]
    assert adc_kernel._fitting_tiles(4096, 400, True) == [1, 2, 4, 8]
    assert adc_kernel._fitting_tiles(4096, 1024, True) == [1, 2, 4, 8]
    for qt, mk, k in ((16, 512, 400), (8, 4096, 1024)):
        assert adc_kernel._shared_bytes(qt, mk, k, True) <= adc_kernel.SMEM_LIMIT
    pq4 = {2: 5, 4: 4, 8: 3, 16: 1}
    pq8 = {2: 5, 4: 2, 8: 1}
    assert adc_kernel._query_tile(1, pq4) == 2
    assert adc_kernel._query_tile(1, {1: 5, **pq4}) == 1
    assert adc_kernel._query_tile(5, pq4) == 8
    assert adc_kernel._query_tile(256, pq4) == 8
    assert adc_kernel._query_tile(256, pq8) == 2
    assert adc_kernel._query_tile(256, {1: 2, 2: 1}) == 1  # none has 3


def test_other_device_raises():
    q = torch.zeros((2, 8), device="meta")
    with pytest.raises(ValueError):
        fused_adc_topk(q, torch.zeros((10, 4), dtype=torch.uint8, device="meta"),
                       torch.zeros((4, 16, 2), device="meta"),
                       torch.zeros(10, device="meta"), 10, 3, DistanceMetric.L2)


# ------------------------------------------- the IVF bucket-bias variant ---

G = 7


def _group_inputs(kind, m, ksub, seed=9):
    """Bucket ids (some −1: tombstoned rows, masked; some −1 on live rows,
    which add no bias) and a per-query bias: three probed buckets of
    integer bias above 256 in magnitude (bf16 rounds them), two of them
    tied (split buckets share a centroid), −1e30 on the rest."""
    books, codes, recon, rnorms, q, mask = _pq_inputs(kind, m, ksub, seed)
    rng = np.random.default_rng(seed + 1)
    gids = rng.integers(0, G, N).astype(np.int32)
    gids[mask == 0] = -1  # tombstoned
    gids[:5] = -1  # live rows in no bucket
    mask[:5] = 1.0
    bias = np.full((NQ, G), -1e30, np.float32)
    for r in range(NQ):
        probed = rng.choice(G, 3, replace=False)
        vals = rng.integers(-3000, 3000, 2).astype(np.float32)
        bias[r, probed] = [vals[0], vals[0], vals[1]]  # a tied pair
    return books, codes, recon, rnorms, q, mask, gids, bias


def _group_scores64(q, recon, metric, gids, bias, live):
    """float64 scores with the bias, −inf for unprobed buckets and dead
    rows (queries as given)."""
    q64, x64 = np.asarray(q, np.float64), np.asarray(recon, np.float64)
    dots = q64 @ x64.T
    inb = gids >= 0
    b = np.where(inb[None, :], bias[:, np.maximum(gids, 0)].astype(np.float64), 0.0)
    dots = dots + b
    norms = (x64 ** 2).sum(1)[None, :]
    metric = DistanceMetric(metric)
    if metric == DistanceMetric.L2:
        s = 2 * dots - norms
    elif metric == DistanceMetric.COSINE:
        s = dots / np.sqrt(np.maximum(norms, 1e-30))
    else:
        s = dots
    dead = inb[None, :] & (b <= -1e28)
    return np.where(dead | ~live[None, :], -np.inf, s)


GROUP_CASES = [  # (kind, m, ksub, packed4, exact_lut, k)
    ("integer", 4, 16, False, True, 10),
    ("integer", 4, 16, True, False, 12),
    ("integer", 5, 16, True, True, 40),
    ("integer", 4, 32, False, False, 300),
    ("normal", 4, 16, True, True, 10),
]


@pytest.mark.parametrize("case", GROUP_CASES, ids=lambda c: "-".join(map(str, c)))
@pytest.mark.parametrize("metric", METRICS)
def test_group_bias_matches_pallas_interpret(metric, case):
    """The plain version's bucket bias against the JAX kernel's
    ``group_bias`` + ``group_ids`` (interpret mode): unprobed buckets never
    surface, tombstoned rows (id −1, mask 0) never do, live rows of id −1
    take no bias, tied buckets tie, and a bf16 LUT rounds the bias."""
    kind, m, ksub, packed4, exact_lut, k = case
    books, codes, recon, rnorms, q, mask, gids, bias = _group_inputs(kind, m, ksub)
    if metric == DistanceMetric.COSINE:
        q = unit_rows(q)
    stored = pack_codes4(codes) if packed4 else codes
    before = fused_adc_topk.launches, fused_adc_topk.group_launches
    s, i = fused_adc_topk(
        torch.from_numpy(q), torch.from_numpy(stored), torch.from_numpy(books),
        torch.from_numpy(rnorms), N, k, metric, torch.from_numpy(mask),
        exact_lut=exact_lut, packed4=packed4, group_bias=torch.from_numpy(bias),
        group_ids=torch.from_numpy(gids))
    assert (fused_adc_topk.launches, fused_adc_topk.group_launches) == before
    want = jax_fused_adc_topk(q, stored, books, rnorms, np.int32(N), k, metric,
                              valid_mask=mask, exact_lut=exact_lut, block_rows=128,
                              interpret=True, packed4=packed4, group_bias=bias,
                              group_ids=gids)
    live = mask != 0
    s64 = _group_scores64(q, recon, metric, gids, bias, live)
    probed_rows = np.isfinite(s64)
    got_i = i.numpy()
    assert probed_rows[np.arange(NQ)[:, None], np.maximum(got_i, 0)][got_i >= 0].all()
    exact = kind == "integer" and metric != DistanceMetric.COSINE
    tol = None
    if not exact:
        finite_b = np.where(bias > -1e28, np.abs(bias), 0).max(1)
        tol = _band(q, books, recon, metric) + 4 * m * 2.0**-24 * finite_b * (
            2 if metric == DistanceMetric.L2 else 1) / (
            np.sqrt(max(rnorms.min(), 1e-30)) if metric == DistanceMetric.COSINE else 1)
        if not exact_lut:  # bf16 rounding of LUT and bias: compare in the band
            tol = tol + 2.0**-8 * np.abs(s64[np.isfinite(s64)]).max()
    assert_topk_match((s.numpy(), got_i), tuple(np.asarray(a) for a in want),
                      exact=exact, tol=tol, scores64=s64)


def test_group_bias_is_rounded_with_a_bf16_lut():
    """On integer data the bf16 variant's scores are the f32 variant's with
    each bias rounded to bf16 (8 significant bits, to nearest even): 2049 →
    2048, 2060 → 2064."""
    books, codes, recon, rnorms, q, mask, gids, _ = _group_inputs("integer", 4, 16)
    books = np.zeros_like(books)  # LUT of zeros: the IP score is the bias
    bias = np.full((NQ, G), -1e30, np.float32)
    bias[:, 1], bias[:, 2] = 2049.0, 2060.0
    out = {}
    for exact_lut in (True, False):
        s, i = fused_adc_topk(
            torch.from_numpy(q), torch.from_numpy(codes), torch.from_numpy(books),
            torch.zeros(N), N, N, DistanceMetric.INNER_PRODUCT,
            torch.from_numpy(mask), exact_lut=exact_lut,
            group_bias=torch.from_numpy(bias), group_ids=torch.from_numpy(gids))
        want = jax_fused_adc_topk(q, codes, books, np.zeros(N, np.float32),
                                  np.int32(N), N, DistanceMetric.INNER_PRODUCT,
                                  valid_mask=mask, exact_lut=exact_lut,
                                  block_rows=128, interpret=True,
                                  group_bias=bias, group_ids=gids)
        assert_topk_match((s.numpy(), i.numpy()), tuple(np.asarray(a) for a in want),
                          exact=True)
        out[exact_lut] = s.numpy()
    # (the live rows in no bucket score 0: no bias)
    assert set(np.unique(out[True][np.isfinite(out[True])])) == {0.0, 2049.0, 2060.0}
    assert set(np.unique(out[False][np.isfinite(out[False])])) == {0.0, 2048.0, 2064.0}


@pytest.mark.parametrize("name", ["bias_without_ids", "bias_rows", "bias_empty",
                                  "ids_length"])
def test_group_shape_checks_raise(name):
    q, codes, books = torch.zeros((2, 8)), torch.zeros((10, 4), dtype=torch.uint8), \
        torch.zeros((4, 16, 2))
    bias, ids = torch.zeros((2, 3)), torch.zeros(10, dtype=torch.int32)
    if name == "bias_without_ids":
        ids = None
    elif name == "bias_rows":
        bias = torch.zeros((3, 3))
    elif name == "bias_empty":
        bias = torch.zeros((2, 0))
    elif name == "ids_length":
        ids = torch.zeros(9, dtype=torch.int32)
    with pytest.raises(ValueError):
        fused_adc_topk(q, codes, books, torch.zeros(10), 10, 3, DistanceMetric.L2,
                       group_bias=bias, group_ids=ids)


def test_group_kernel_checks_and_shared_memory():
    """The CUDA-side checks of the bucket variant (dtypes), and its shared
    memory: the two tiles' row ids, then per 32 buckets a word of the
    union's bits and an entry of the chunk prefix (one more at the end)."""
    q, codes, books = torch.zeros((2, 8)), torch.zeros((10, 4), dtype=torch.uint8), \
        torch.zeros((4, 16, 2))
    with pytest.raises(ValueError, match="int32"):
        adc_kernel._check_cuda(q, codes, books, torch.zeros(10), 3, None, True,
                               torch.zeros((2, 3)), torch.zeros(10, dtype=torch.int64))
    adc_kernel._check_cuda(q, codes, books, torch.zeros(10), 3, None, True,
                           torch.zeros((2, 3)), torch.zeros(10, dtype=torch.int32))
    assert adc_kernel._group_words(1) == 1 and adc_kernel._group_words(1500) == 47
    base = adc_kernel._shared_bytes(8, 512, 400, True)
    assert adc_kernel._shared_bytes(8, 512, 400, True, gw=47) == (
        base + 2 * 4 * 256 + 2 * 47 * 4 + 4)
    # sift1m-ivfpq4's shapes keep the tiles the plain scan has
    assert adc_kernel._fitting_tiles(512, 400, True, gw=64) == [1, 2, 4, 8, 16]
