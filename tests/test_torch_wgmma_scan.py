"""The host side of K1's tensor-core scans (``csrc/wgmma_scan.cuh``,
``csrc/topk_int_kernel.cu`` over int8 or bf16, ``csrc/topk_high_kernel.cu``),
which the CPU can check without a kernel: the shapes ``_int_shape`` (over
D bytes a row for int8, 2 D for bf16) and ``_high_shape`` pick (shared
memory within the card's limit at every k, the tile of queries that holds
the batch, one wave of blocks), and ``_tma_rows``, which copies rows into
zero-padded ones exactly when TMA cannot read them as they are. The kernels
themselves run on the card (``chip_smoke.py`` phases 13 and 14)."""

import types

import numpy as np
import pytest
import torch

from metrovector_tpu_torch.ops import topk_kernel as tk

BATCHES = (1, 2, 8, 16, 31, 32, 33, 64, 65, 100, 128, 129, 200, 255, 256)
KS = (1, 2, 10, 18, 22, 31, 64, 100, 127, 128, 129, 256, 257, 1000, 5000)


def _shape(kind, nq, d, k):
    if kind == "bf16":
        return tk._int_shape(nq, 2 * d, k)
    return tk._int_shape(nq, d, k) if kind == "int" else tk._high_shape(nq, k)


@pytest.mark.parametrize("d", [16, 96, 100, 128, 512, 960, 1536, 3072])
@pytest.mark.parametrize("kind", ["int", "high", "bf16"])
def test_scan_shared_memory_at_every_k(kind, d):
    """Every shape fits the 227 KB a block may take, with a ring of at least
    MIN_STAGES, and its bytes are wgmma_scan.cuh::scan_smem's. The bf16
    scan's stage is 64 rows of 64 dims, 128 bytes a row as the integer
    scan's."""
    nch = -(-(2 * d if kind == "bf16" else d) // tk.INT_CHUNK)
    for nq in BATCHES:
        for k in KS:
            s = _shape(kind, nq, d, k)
            assert s.smem <= tk.SMEM_LIMIT, (nq, k)
            qb = 2 * s.nw
            if kind in ("int", "bf16"):
                stage = 64 * tk.INT_CHUNK + (0 if s.resident else qb * tk.INT_CHUNK)
                q_bytes = nch * qb * tk.INT_CHUNK if s.resident else 0
                top = tk.INT_MAX_STAGES
            else:
                stage, q_bytes, top = 64 * 32 * 4 + qb * 128, 0, tk.HIGH_MAX_STAGES
            assert tk.MIN_STAGES <= s.stages <= top
            assert s.smem == tk._scan_smem(stage, s.stages, q_bytes, s.nw,
                                           0 if s.big else k)
            assert s.big or k <= tk.SCAN_SMEM_K
            if s.stages < top:  # as many stages as fit
                assert s.smem + stage + 16 > tk.SMEM_LIMIT


@pytest.mark.parametrize("kind", ["int", "high", "bf16"])
def test_scan_tile_follows_the_batch(kind):
    """The tile is the least 2 NW that holds the batch (up to 256 queries
    for the integer and the bf16 scans, 128 for bf16x3) while it fits; at
    the main path's k (10, and 18 with the margin) it always does, with
    lists in shared memory, and the integer scan keeps the queries of D <=
    128 resident. The bf16 scan keeps its queries of D = 128 resident too,
    and its tile of 256 (whose 256 queries of selection state and 64 KB of
    queries leave no room for lists beside a ring) keeps its lists in
    device memory."""
    top = 128 if kind == "high" else 256
    dims = {"int": (96, 128), "high": (128, 960), "bf16": (100, 128)}[kind]
    for nq in BATCHES:
        for k in (10, 18):
            for d in dims:
                s = _shape(kind, nq, d, k)
                want = min(max(-(-nq // 2), 16), top // 2)
                want = 1 << (want - 1).bit_length()
                assert s.nw == want, (nq, k, d)
                assert s.big == (kind == "bf16" and s.nw == 128), (nq, k, d)
                assert s.resident == (kind != "high")


@pytest.mark.parametrize("kind", ["int", "high", "bf16"])
@pytest.mark.parametrize("nq", BATCHES)
def test_scan_plan_is_one_wave(monkeypatch, kind, nq):
    """_plan over the shape's tile gives at most one block per SM (the
    scans take one: 384 threads, ~224 KB) whose splits cover the rows in
    whole stages; the integer and the bf16 scans read the rows once for
    the whole batch (one tile of queries), bf16x3 once per 128 queries."""
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda dev: types.SimpleNamespace(multi_processor_count=132))
    n, d = 1_000_003, {"int": 96, "high": 960, "bf16": 128}[kind]
    for k in (10, 100, 257):
        s = _shape(kind, nq, d, k)
        tile = (2 * s.nw, tk.SCAN_ROWS)
        splits, rows_per_split, length, tree, *_ = tk._plan(
            torch.device("cpu"), nq, n, k, 0 if s.big else k, tile,
            lambda k_smem, big: 1)
        q_tiles = -(-nq // tile[0])
        assert q_tiles == (-(-nq // 128) if kind == "high" else 1)
        assert q_tiles * splits <= 132
        assert splits >= 132 // q_tiles - 1
        assert rows_per_split % tk.SCAN_ROWS == 0
        assert (splits - 1) * rows_per_split < n <= splits * rows_per_split
        assert length == (min(k, rows_per_split) if s.big else k)


def _aligned(t):
    return (t.stride(0) * t.element_size()) % 16 == 0 and t.data_ptr() % 16 == 0


@pytest.mark.parametrize("case", [
    "int8_d96", "int8_d100", "int8_d128_view96", "int8_offset_row", "int8_d1536",
    "f32_d100", "f32_d33", "f32_offset_col", "f32_d960", "bf16_d100", "bf16_d128",
    "bf16_d960_view",
])
def test_tma_rows_copies_exactly_when_unaligned(case):
    """_tma_rows returns the tensor itself where its row stride and base are
    16-byte multiples, else a copy whose rows are the first D values of
    zero-padded rows of the next 16-byte stride."""
    rng = np.random.default_rng(3)
    dtype = {"int8": torch.int8, "f32": torch.float32, "bf16": torch.bfloat16}[
        case.split("_")[0]]
    base = {
        "int8_d96": (7, 96), "int8_d100": (7, 100), "int8_d128_view96": (7, 128),
        "int8_offset_row": (8, 112), "int8_d1536": (3, 1536), "f32_d100": (7, 100),
        "f32_d33": (7, 33), "f32_offset_col": (7, 21), "f32_d960": (3, 960),
        "bf16_d100": (7, 100), "bf16_d128": (5, 128), "bf16_d960_view": (3, 968),
    }[case]
    full = (torch.from_numpy(rng.integers(-128, 128, base, dtype=np.int8))
            if dtype == torch.int8
            else torch.from_numpy(rng.standard_normal(base).astype(np.float32)).to(dtype))
    t = {"int8_d128_view96": full[:, :96], "int8_offset_row": full[1:, :100],
         "f32_offset_col": full[:, 1:], "bf16_d960_view": full[:, :960]}.get(case, full)
    got = tk._tma_rows(t)
    if _aligned(t):
        assert got is t
    else:
        assert got is not t
        assert _aligned(got)
        assert got.stride(1) == 1 and got.shape == t.shape
        assert got.stride(0) == -(-t.shape[1] * t.element_size() // 16) * 16 // t.element_size()
        assert torch.equal(got, t)
        pad = got.as_strided((got.shape[0], got.stride(0)), (got.stride(0), 1))
        assert not pad[:, t.shape[1]:].any()
    copied = {"int8_d96": False, "int8_d100": True, "int8_d128_view96": False,
              "int8_offset_row": False, "int8_d1536": False, "f32_d100": False,
              "f32_d33": True, "f32_offset_col": True, "f32_d960": False,
              "bf16_d100": True, "bf16_d128": False, "bf16_d960_view": False}[case]
    assert (got is not t) == copied
