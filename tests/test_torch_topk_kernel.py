"""The port's ``fused_topk`` wrapper on CPU tensors (its plain path) against
the JAX package's Pallas ``fused_topk`` run in interpret mode, as the JAX
package's own kernel tests run it. Also: the wrapper's input checks, that
CPU tensors never count as kernel launches, and that asking for CUDA where
there is none raises instead of falling back."""

import numpy as np
import pytest
import torch

import ml_dtypes
from metrovector_tpu import Builder, DistanceMetric
from metrovector_tpu.ops import fused_topk as jax_fused_topk
from metrovector_tpu_torch.ops import topk_kernel
from metrovector_tpu_torch.ops.topk_kernel import fused_topk, fused_topk_reference

from _torch_parity import (
    METRICS,
    assert_topk_match,
    exact_scores,
    make_data,
    sq_norms,
    tolerance,
    unit_rows,
)

N, D, NQ = 640, 128, 19


def _inputs(kind, metric, seed=3):
    rng = np.random.default_rng(seed)
    x, q = make_data(rng, kind, N, D, NQ)
    if metric == DistanceMetric.COSINE:
        q = unit_rows(q)
    mask = (rng.random(N) > 0.25).astype(np.float32)
    return x, q, sq_norms(x), mask


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("kind", ["integer", "normal"])
@pytest.mark.parametrize("metric", METRICS)
def test_cpu_path_matches_pallas_interpret(metric, kind, masked):
    x, q, norms, mask = _inputs(kind, metric)
    num_valid, vm, k = (N - 41, mask, 12) if masked else (N, None, 10)
    before = fused_topk.launches
    got = fused_topk(torch.from_numpy(q), torch.from_numpy(x),
                     torch.from_numpy(norms), num_valid, k, metric,
                     None if vm is None else torch.from_numpy(vm))
    assert fused_topk.launches == before  # the plain path is no launch
    want = jax_fused_topk(q, x, norms, np.int32(num_valid), k, metric,
                          valid_mask=vm, block_rows=256, interpret=True)
    live = np.arange(N) < num_valid
    if vm is not None:
        live &= vm != 0
    assert_topk_match(
        tuple(t.numpy() for t in got), tuple(np.asarray(a) for a in want),
        exact=kind == "integer" and metric != DistanceMetric.COSINE,
        tol=tolerance(q, x, metric), scores64=exact_scores(q, x, metric, live),
    )


@pytest.mark.parametrize("storage", ["float16", "bfloat16"])
@pytest.mark.parametrize("metric", [DistanceMetric.L2, DistanceMetric.INNER_PRODUCT])
def test_half_storage_matches_pallas(metric, storage):
    """f16 stays f16 in the port where the reference upcasts it to f32
    (f16 ⊂ f32: same values); bf16 goes to both as bf16, with bf16-rounded
    queries. Integer data: bit-identical."""
    x, q, norms, _ = _inputs("integer", metric, seed=4)
    tdt = getattr(torch, storage)
    got = fused_topk(torch.from_numpy(q).to(tdt).float(),
                     torch.from_numpy(x).to(tdt), torch.from_numpy(norms),
                     N, 10, metric)
    if storage == "float16":
        want = jax_fused_topk(q, x.astype(np.float16).astype(np.float32), norms,
                              np.int32(N), 10, metric, block_rows=256,
                              interpret=True)
    else:
        bf = ml_dtypes.bfloat16
        want = jax_fused_topk(q.astype(bf), x.astype(bf), norms, np.int32(N),
                              10, metric, block_rows=256, interpret=True)
    assert_topk_match(tuple(t.numpy() for t in got),
                      tuple(np.asarray(a) for a in want), exact=True)


@pytest.mark.parametrize("n, d, k", [
    (1200, 128, 257), (1200, 128, 1000), (1200, 128, 1200),
    (600, 1536, 10), (600, 1536, 300),
])
@pytest.mark.parametrize("metric", [DistanceMetric.L2, DistanceMetric.INNER_PRODUCT])
def test_any_k_and_wide_dim_match_pallas_interpret(metric, n, d, k):
    """k above the old 256 up to k = N, and D = 1536, as the JAX kernel takes
    them. Values in [0, 15] keep every score exact in f32 at D = 1536, so the
    results are identical."""
    rng = np.random.default_rng(9)
    x = rng.integers(0, 16, (n, d)).astype(np.float32)
    q = rng.integers(0, 16, (7, d)).astype(np.float32)
    norms = sq_norms(x)
    got = fused_topk(torch.from_numpy(q), torch.from_numpy(x),
                     torch.from_numpy(norms), n - 3, k, metric)
    want = jax_fused_topk(q, x, norms, np.int32(n - 3), k, metric,
                          block_rows=256, interpret=True)
    assert_topk_match(tuple(t.numpy() for t in got),
                      tuple(np.asarray(a) for a in want), exact=True)


def test_k_above_valid_rows_gives_sentinels():
    x, q, norms, _ = _inputs("normal", DistanceMetric.L2)
    s, i = fused_topk(torch.from_numpy(q), torch.from_numpy(x),
                      torch.from_numpy(norms), 7, 20, DistanceMetric.L2)
    assert (i[:, 7:] == -1).all() and torch.isneginf(s[:, 7:]).all()
    assert (i[:, :7] >= 0).all() and (i[:, :7] < 7).all()


def test_reference_ties_go_to_lowest_index():
    """Duplicate rows tie exactly; the lower row index must come first."""
    rng = np.random.default_rng(2)
    base = rng.integers(0, 16, (40, 8)).astype(np.float32)
    x = base[rng.integers(0, 40, 500)]
    q = rng.integers(0, 16, (6, 8)).astype(np.float32)
    s, i = fused_topk_reference(torch.from_numpy(q), torch.from_numpy(x),
                                torch.from_numpy(sq_norms(x)), 500, 30,
                                DistanceMetric.INNER_PRODUCT)
    s, i = s.numpy(), i.numpy()
    for r in range(6):
        same = s[r][1:] == s[r][:-1]
        assert (i[r][1:][same] > i[r][:-1][same]).all()


def _bad_inputs(name):
    q = torch.zeros((2, 16))
    x = torch.zeros((64, 16))
    nrm = torch.zeros(64)
    k = 10
    if name == "k_zero":
        k = 0
    elif name == "k_above_limit":  # the limit is the corpus: k <= N
        k = 65
    elif name == "int8_corpus":
        x = torch.zeros((64, 16), dtype=torch.int8)
    elif name == "dim_mismatch":
        x = torch.zeros((64, 8))
    elif name == "not_contiguous":
        x = torch.zeros((16, 64)).T
    elif name == "norms_dtype":
        nrm = torch.zeros(64, dtype=torch.float64)
    return q, x, nrm, k


@pytest.mark.parametrize("name", [
    "k_zero", "k_above_limit", "int8_corpus",
    "dim_mismatch", "not_contiguous", "norms_dtype",
])
def test_kernel_input_checks_raise(name):
    q, x, nrm, k = _bad_inputs(name)
    with pytest.raises(ValueError):
        topk_kernel._check(q, x, nrm, k, None)


@pytest.mark.parametrize("k, d", [
    (10, 128), (256, 128), (257, 128), (2000, 128),
    (10, 512), (10, 1024), (300, 1536), (10, 3072),
])
def test_kernel_takes_any_k_and_dim(k, d):
    """The checks take every 1 <= k <= N and any D (queries and corpus are
    staged 16 dims at a time, so D sets no shared memory); a scan block of
    the default 32 x 256 tile, and of the sweep's 64 x 128 one, fits. At
    k <= 100 a 32 x 256 block, and at k = 10 a 64 x 128 one, leave room
    for two blocks on an SM."""
    n = 2000
    topk_kernel._check(torch.zeros((2, d)), torch.zeros((n, d)), torch.zeros(n),
                       k, None)
    assert topk_kernel._TILE == topk_kernel.TILE_32x256
    two_blocks = (233_472 - 2 * 1024) // 2
    for tile in topk_kernel._TILES:
        assert topk_kernel._shared_bytes(k, tile) <= topk_kernel.SMEM_LIMIT
    if k <= 100:
        assert topk_kernel._shared_bytes(k, topk_kernel.TILE_32x256) <= two_blocks
    if k <= 10:
        assert topk_kernel._shared_bytes(k, topk_kernel.TILE_64x128) <= two_blocks


def test_other_device_raises():
    q = torch.zeros((2, 16), device="meta")
    with pytest.raises(ValueError):
        fused_topk(q, q, torch.zeros(2, device="meta"), 2, 1, DistanceMetric.L2)


def test_cuda_request_without_cuda_raises(tmp_path):
    from metrovector_tpu_torch import SearchEngine
    from metrovector_tpu_torch.engine import DeviceSpace

    if torch.cuda.is_available():
        pytest.skip("this host has CUDA; the refusal is for hosts without it")
    b = Builder()
    b.add_vector_space("v", dim=4)
    b.add_vectors("v", np.eye(4, dtype=np.float32))
    path = tmp_path / "c.mvt"
    b.build().save(path)
    with pytest.raises(RuntimeError, match="cuda"):
        SearchEngine.open(path, device="cuda")
    with pytest.raises(RuntimeError, match="cuda"):
        SearchEngine.open(path)  # the default device is CUDA, never a fallback
    state = {"data": np.zeros((8, 4), np.float32), "norms": np.zeros(8, np.float32),
             "num_valid": 8, "dim": 4, "metric": 0, "dtype": 0}
    with pytest.raises(RuntimeError, match="cuda"):
        DeviceSpace.from_state(state, device="cuda")
