#!/usr/bin/env python3
"""Drive the PyTorch + CUDA port's main path once on one NVIDIA GPU.

    python3 chip_smoke.py [--parent DIR]

With ``--parent DIR`` (another checkout of the port, such as the parent
commit unpacked by ``git archive``) it also times that checkout's K1-K4
and its ``search()`` p50 on this run's dense and PQ files beside this
one's, one process each (``tools/scan_kernel_timing.py``).

Phases, one line each; any failure exits non-zero:

0. device: require CUDA, print the card's name and power limit, pin full
   f32 (no TF32) for matmul and cuDNN;
1. build: compile the fused top-k kernel from the sources in this checkout;
2. kernel vs plain: ``fused_topk`` against ``fused_topk_reference`` on the
   same CUDA tensors over metrics, corpus dtypes, masks, batch sizes and k;
   then over 200,003 integer rows with twins across splits (f32/f16/bf16,
   D in {128, 100, 1536}, batches 1, 33, 37, 255, k in {10, 100, 256,
   257}, num_valid ending inside a split, a mask that empties whole
   splits), each case run twice and identical to the plain version; and an
   f16 space at precision "default" as the engine holds it (bf16 rows, f32
   queries that bf16 cannot hold), within the band;
3. main path at full size: ``Builder`` writes a 1M x 128 integer-valued
   f32 L2 space, ``Reader.open`` -> ``SearchEngine(device="cuda")`` ->
   ``search`` at k=10 (batches 32-256) and k=100, recall against a float64
   NumPy oracle, the kernel's launch count, and CUDA-event times of the
   kernel and of its plain version, and of one ``torch.mm`` of the batch-256
   product as a yardstick for the scan alone;
4. filters, tombstones and stable IDs;
5. serving: the shared ``MicroBatcher`` answers 64 concurrent requests;
6. ADC kernel vs plain: ``fused_adc_topk`` against
   ``fused_adc_topk_reference`` over metrics, uint8 and packed4 codes, f32
   and bf16 LUTs, batch sizes, k up to 1024 and masks; then over 200,003
   rows of codes with twins across splits (pq4 and pq8, f32 and bf16 LUTs,
   integer and float codebooks, batches 1, 33, 37, 255, k in {1, 10, 400},
   num_valid and masks as in phase 2), bit-identical on float data too and
   run twice on integer data;
7. gather and rescore kernels vs plain: ``gather_rows`` bit for bit over
   dtypes, int32 and int64 indices, clamped indices, odd and unaligned
   rows; ``rescore_candidates`` in both tie modes over metrics, then under
   every split plan of ``rescore_plan`` at batches 1, 32, 256 and 600 (twins
   across splits, a split of -1 only), identical twice on integer data;
8. the PQ path at full size: a 1M x 128 clustered corpus, PQ trained and
   encoded on the card, ``Builder.set_pq_index`` -> ``Reader.open`` ->
   ``PQIndex.from_space(device="cuda")`` -> ``search(k=10, rerank=400)``
   at batches 256 and 32 for 4-bit m=32 and 8-bit m=16 codes, recall
   against a float64 oracle on the card, the kernels' launch counts, the
   result held against the plain re-rank, CUDA-event times of each kernel
   and its plain version; ``sift1m-pq`` (ksub = 256) also at
   ``search(k=10, rerank=400, int8_lut=True)``, batches 256 and 32 (the
   int8 LUT's lookup scan: recall@10 >= 0.99, the kernel identical to its
   plain version, its time beside the bf16 LUT's and both bounds); then a
   20k-row corpus with a full re-rank;
9. any k and any D: ``fused_topk`` at k in {257, 1000, 1025, 5000, N} over
   20k rows and at D in {1536, 3072}, ``fused_adc_topk`` at k in {1025,
   4096, N}, ``rescore_candidates`` at R in {4097, 8192} in both tie modes,
   each against its plain version, and both scans at k equal to the rows
   of a split; then at full size ``sift1m-pq4``
   ``search(k=10, rerank=2000)`` (K2 then K3, recall against the float64
   oracle) and ``SearchEngine.search(k=1000)`` on the 1M x 128 corpus,
   identical to the plain version;
10. sparse kernels vs plain: ``query_postings`` against
   ``query_postings_reference`` (signed zeros, inf, NaN, several query
   tiles); ``ell_dots`` and ``ell_topk`` against ``ell_dots_reference`` and
   ``ell_topk_reference`` over metrics, batch sizes, k up to 2000, overflow
   rows, empty rows, tombstones, a filter and k above the rows left, for
   dense queries and for sparse ones (64 nonzeros of 4,096 columns, one
   query all zero, a term in every query, -0.0 entries; most rows score 0
   and ties decide); ``ell_dots`` with a +inf corpus value, NaN for NaN;
   both kernels on a batch past one launch's postings (two launches each);
11. the sparse path at full size (``sparse1m``): a 1M x 30,522 corpus of 48
   entries a row (the algebra of benchmarks/suite.py::bench_sparse1m,
   seed 12), ``Builder.add_sparse_vectors`` -> ``Reader.open`` ->
   ``SparseSearchEngine(device="cuda")`` (ELL) -> ``search(k=10)`` at
   batches 256 and 32, recall@10 against a float64 oracle on the card, one
   ``ell_topk`` launch per search; at both batches ``ell_topk`` and
   ``query_postings`` held against their plain versions, CUDA-event times
   of ``ell_topk``, its plain version, the postings build apart,
   ``ell_dots`` against ``torch.sparse.mm``, ``search`` end to end, the
   dense-query worst case (batch 32, every query fully dense), and the COO
   formulation once;
12. the IVF-PQ path at full width: ``fused_adc_topk``'s bucket-bias form
   (``group_bias`` + ``group_ids``, grouped on the card and run by the
   bucket kernel) against its plain version on 200,003 rows (twins across
   splits, tombstoned and unbucketed rows, a filter, tied and unprobed
   buckets, bf16-rounded biases, 1,500 and 40,000 buckets, k up to 1100),
   and the bucket kernel over a bucket layout (``buckets=``: shuffled
   buckets, tombstoned slots, twins in other buckets, a fetch above the
   probed rows, k up to 3000), identical; a 20k-row ``IVFIndex`` whose
   full probe is exact search; then ``benchmarks/suite.py``'s
   ``sift1m-ivfpq`` (8-bit m=16) and ``sift1m-ivfpq4`` (4-bit m=32,
   packed): the 1M x 128 clustered corpus of
   seed 7, ``train_ivfpq`` on the card (C = 1024, 4 iterations),
   ``Builder.set_ivf_index`` + ``set_pq_index(residual=True)`` ->
   ``Reader.open`` -> ``IVFPQIndex.from_space(device="cuda")`` ->
   ``search(k=10, nprobe=16)`` in both modes at batches 8, 32 and 256 and
   rerank 100 and 400 (one variant launch a scan, none a probe, one rescore
   a search), recall@10 against a float64 oracle on the card (>= 0.99 at
   rerank 400), at batches 1, 8 and 256 the bucket kernel at the main
   path's inputs against its plain version (fetch 400), ``_masked_scan``
   under ``torch.cuda.set_sync_debug_mode("error")`` (no host
   synchronization), the kernel's device time beside its plain version's
   and both bounds (every row's bytes; the probed work of this run), the
   scan of every row and the call with no bucket probed at 256, the scan's
   ``search()`` step by step, and ``search()`` p50 of both modes at batches
   1 to 256 (the crossover of the modes);
13. the dense engine's precision ladder: (a) ``fused_topk(precision=
   "high")`` (the bf16x3 tensor-core kernel, ``wgmma`` fed by TMA) against
   its plain version over the three metrics, batches 1, 33 and 255, k in
   {10, 100, 257} and D in {100, 128, 960, 1536}: 200,003 integer rows with
   twins across splits, num_valid and masks as in phase 2 (identical,
   twice), with the scan tiles' edges (batches 8, 64, 128, 129 and 256
   over 100,037 rows, which end inside a 64-row stage, at D 128 and 960),
   and N(0, 1) rows (within the band); (b) the certificate: the scan's error against its
   raw bound (rows in [0, 1), where nothing cancels, and N(0, 1) rows; the
   ratio printed), and the planted near-tie and 40-copies corpora, where
   ``high_verified`` must fall back and equal ``highest``; (c)
   ``benchmarks/suite.py``'s gist1m (1M x 960 N(0, 1) f32 of seed 3,
   cosine, ``pad_dims=False``): ``Builder`` -> ``Reader.open`` ->
   ``SearchEngine(device="cuda", precision="high_verified")``, k = 10,
   margin 8, at batches 64 and 256, and the phase 3 corpus at batches 32 and
   256 (identical to ``highest``): the launch counts, recall@10 against a
   float64 oracle on the card (1.000 gated for ``high_verified``,
   ``high`` and ``highest`` reported), ``verify_stats``, the measured error
   against the certificate's raw bound, and CUDA-event times of the
   variant (beside the time of the ``mma.sync`` kernel it replaces, from
   ``PERF.md``),
   its plain version, K1 ``highest``, K3's re-score at R = 18 and
   ``search()`` p50 at each precision;
14. quantized and bf16 spaces: (a) K1's integer variant
   (``ops/csrc/topk_int_kernel.cu``, ``wgmma`` s8 fed by TMA) against its
   plain version on 200,003 int8 rows with twins across splits, D in {96,
   100, 1536}, the three metrics, int8 with a scale (deferred for IP) and
   the uint8 offset form with ``bias_row``, batches 1, 33 and 255, k in
   {10, 100, 257}, num_valid and masks as in phase 2, then the scan tiles'
   edges (batches 8, 64, 128, 129 and 256 over 100,037 rows at D 96 and
   1536) (identical, twice); the shared memory the wrapper plans for the
   tensor-core scans (K2's int8-LUT product too) against the library's own
   sizes; the affine int8 load of ``topk_kernel.cu`` within phase 2's band;
   K2's int8 LUT on both routes (``ops/adc_kernel.py::int8_lut_route``:
   the tensor-core product ``adc_int8_mma_kernel.cu`` at ksub <= 16 while
   32 queries' LUT fits a block, else the lookup scan) over pq4 and pq8
   codes with twins, the three metrics, k in {1, 10, 400}, then unpacked
   ksub=16 codes, ksub=8, m = 23 and 24, batches 128, 129 and 256, k =
   1024, 1025 and N, the product's largest m (270 packed, 199 not) and
   pq4 LUTs past it on the lookup route (m = 288 packed, 200 not), and
   LUTs of +-127 alone (m = 32; 256 and 257 at ksub = 256, the lookup
   lanes' bound; 288 and 513 packed at ksub = 16) (identical, twice);
   (b) ``benchmarks/suite.py``'s deep10m (10M x 96 int8 codes of
   seed 4, IP, quantization scale 0.02): ``Builder`` in chunks ->
   ``Reader.open`` -> ``SearchEngine(device="cuda")`` -> ``search(k=10)`` at
   batches 128 and 32, recall@10 1.000 against a float64 oracle of the
   queries as the engine quantized them, the variant's launch count; (c)
   sift1m-u8 (1M x 128 uint8 of seed 2, L2, identity quantization, batch
   256) identical to the plain version, recall against the oracles of the
   quantized and of the raw queries, and the same codes as a uint8 cosine
   space through the affine load, within the band; (d) phase 8's
   ``sift1m-pq4`` index at ``search(k=10, rerank=400, int8_lut=True)``,
   batches 256 and 32, recall@10 >= 0.99, one launch of the tensor-core
   product a search, its time beside the bf16 LUT's and both bounds (the
   CUDA cores' adds, the tensor cores' product); (e) the phase 3 corpus written as
   BFLOAT16, identical to the f32 space; (f) CUDA-event times of each new
   kernel and its plain version, ``torch._int_mm`` of the batch's product
   as a yardstick for the integer scan, the times of the ``mma.sync``
   kernel it replaces (from ``PERF.md``), and ``search()`` p50.

15. presampled and group_rows: the main path, counted: one
   ``fused_topk_presampled`` call (K1's two-phase scan: phase 1 over every
   64th row, phase 2 seeded with its top-k, the seed's k-th entry the
   floor of every split's bar) at k = 100 on each of the phase 3 corpus,
   deep10m and gist1m at ``high``, each phase one launch of its route's
   kernel, identical to ``fused_topk`` and to its plain version (on
   gist1m's float data within phase 13's band of it); (a) the same
   function against
   ``fused_topk``, ``fused_topk_reference`` and
   ``fused_topk_presampled_reference`` on 200,003 rows with twins across
   splits, on the FFMA kernel (f32, f16, bf16), ``high``, int8 IP with a
   deferred scale and int8 L2, strides 16, 64 and 1,000, k in {1, 10, 100,
   257, 1000, 1025}, batches 1, 33 and 255, num_valid inside a split and
   off the stride, a mask that kills every subsampled row, k above the
   subsample's rows (identical, twice); (b) CUDA-event times of phase 1,
   phase 2 and the whole at stride 64 beside plain ``fused_topk`` and the
   plain version on the same queries, on the phase 3 corpus (batches 32
   and 256, k 10, 100 and 1,000), phase 14's deep10m (batch 128, k = 100)
   and phase 13's gist1m at ``high`` (batch 256, k 18 and 100), each
   beside K1's bound (the function returns K1's answer, so phase 1 is a
   time of its own, not a larger bound), and the integer scan's offers and
   flushes with and without the seed (``tools/wgmma_scan_profile.py
   --seed-counts``, its variant built in phase 1); (c) phase 12's
   ``sift1m-ivfpq`` bucket layout read as rows bucket-major, padded to
   ``group_rows`` (one counted call at each batch's first inputs, the
   main path): ``fused_adc_topk(group_rows=)`` identical to the
   ``group_ids`` form, to its plain version and in its scores to the
   row-order call, at the main path's inputs (batches 1, 8, 256, fetch
   400), a ragged N whose tail bucket is longer than ``group_rows``
   (identical, twice, to both), and its device time.
16. live mutation and the facade, through the public entry points, each
   count at 0 before a public call and read after (``_Tally``), each
   search held against the same call with every kernel swapped for its
   plain version (``plain_versions``): (a) the phase 3 file through
   ``Database.open(path).engine("sift", mode="exact")``, 50,000 integer
   rows appended across capacity (1M -> 1.5M rows), 50,000 within it
   (``data_ptr`` unchanged), 1,000 rows deleted by id and 1,000 by
   position, a batch-256 k=10 search after each step identical to the
   plain version with no deleted row; ``add_rows`` ms at the growth step
   and within, ``search()`` p50 before and after; ``high_verified`` after
   rows of 4x the largest norm, identical to "highest", its
   ``verify_stats``; phase 14's deep10m (int8 IP), sift1m-u8 (uint8 L2)
   and uint8 cosine spaces (the affine load, within phase 14's band) and
   the phase 3 corpus written as BFLOAT16, each grown across and within
   capacity (float rows quantized by the space's calibration) and
   trimmed; (b) a ``MicroBatcher`` (``pipeline=False``, then ``True``)
   over a fresh engine of the phase 3 file, 32 client threads sending
   2,000 requests while a writer appends 20 chunks of 10,000 rows (across
   a capacity step) and deletes 100 after each: every answer below the row
   count published when it returned, holding no row deleted before its
   submit, its ids its rows; afterwards identical to the plain version;
   (e) one file with ``sift1m-pq``'s and ``sift1m-ivfpq``'s sidecars over
   their 1M rows, an IVF space and a 20,000-row HNSW space:
   ``Database.engine(mode="auto")`` routes each to its index (identical to
   its plain versions; the footprint estimate equal to ``nbytes``),
   ``mode="exact"`` bypasses it, a budget of one space evicts the least
   recently used, the batcher answers as ``search()``; (c) phase 8's
   ``sift1m-pq4`` and ``sift1m-pq`` indexes grown by 200,000 rows (across
   capacity) and trimmed by 1,000: ``search(k=10, rerank=400)`` with the
   f32 and the int8 LUT at batch 256, K2 against its plain version by
   phase 8's rule and K3 identical on the grown index, recall@10 >= 0.99
   against the float64 oracle of the grown corpus; (d) phase 12's
   ``sift1m-ivfpq`` grown by 100,000 rows in groups of the corpus's shape
   drawn off rows of 8 clusters, which overflow into new buckets (groups
   apart from the cluster's own, as ``_p16_ivfpq`` says why): both modes
   at batches 1, 8 and 256
   identical to their plain versions, recall@10 >= 0.99 at rerank 400 with
   appended rows returned; then 1,000 deleted, ``rebuild()`` and again;
   IVF flat over the same rows and quantizer, the same overflow. Every
   kernel of the slice must have launched on this path; its launches are
   added to the kernels line's.
17. autotune and the CLI, on copies of earlier phases' files (kept as each
   phase wrote them): (a) ``autotune(persist=True)`` of ``SearchEngine``
   on phase 3's file and on deep10m (batch 128, k = 10), ``PQIndex`` on
   ``sift1m-pq4`` with the f32 LUT and with ``int8_lut=True`` (batch 256,
   rerank 400), ``IVFPQIndex`` on ``sift1m-ivfpq4`` in the scan mode
   (batches 8 and 256, fetch 400) and ``SparseSearchEngine`` on
   ``sparse1m`` (batch 256, k = 10), over the launch grid (waves 0.5, 1, 2
   and 4 of one wave of scan blocks; K2's lookup scan and K4 also their
   query tiles): every measured candidate's answer identical to the
   default plan's, the winner applied, a fresh open adopting it and
   searching identically; each report printed beside the default's time;
   a PQ grid of tile 32 tuned at k = 10 with the bf16 LUT, adopted, serving
   rerank 400 with the f32 LUT (where tile 32 does not fit) identically;
   the bucket kernel's own device time at each waves (batches 8 and 256);
   (b) ``python -m metrovector_tpu_torch`` in six subprocesses at once:
   ``info``, ``validate --checksum``, ``search -k 10`` on phase 3's file
   and on ``sparse1m`` (JSON lines equal to the library's answer), ``tune
   --save`` and ``tune --index --save`` on copies, whose saved grids a
   fresh ``Database`` adopts (a round-trip check: those tunings share the
   card with the other subprocesses, so their winners are no tuning
   result).
18. streaming (``StreamingSearcher``: pinned staging buffers, the copy of
   chunk j+1 on a side stream under K1's scan of chunk j), each case
   identical to the resident ``SearchEngine`` on the same file: (a)
   ``benchmarks/suite.py``'s stream cell, 1M x 768 f16 N(0, 1) of seed 5,
   16 queries, k = 10, chunks of 262,144 rows, with its recall gate against
   a float64 oracle on a subsample; (b) phase 3's file at batches 32 and 256,
   k = 10 and 100, chunks of 131,072 and 100,000 rows; (c) the same rows
   with phase 4's deletion among 1,000 tombstones and a filter of a tenth
   of the rows; (d) deep10m (int8 IP, batch 128), (e) sift1m-u8 (uint8 L2,
   batch 256) and (f) its uint8 cosine space (the affine load), at the
   default chunk; for each, the streamed wall p50, the bytes shipped, one
   chunk's pinned-to-device ``copy_`` bandwidth and the bound it sets,
   K1's per-chunk CUDA-event times, and the resident p50.
19. sharding (the ``parallel`` package): 4 shards, a card each on a
   machine with 4 cards, else all resident on cuda:0, over the files that
   phases 17-18 keep; each case against its resident search of the same
   run, sharded p50 beside resident p50: (a) phase 3's file through
   ``ShardedDeviceSpace`` at batch 256, k = 10 and 32, k = 100, identical;
   ``grid_sharded_topk`` on 2 x 2 and ``query_sharded_topk`` on 4,
   identical; ``dim_sharded_topk`` on 4, rank-identical; phase 18's
   tombstoned copy with a 30 % filter, raw and prepared, identical; (b)
   deep10m, sift1m-u8 and uint8 cosine (within phase 14's band);
   (c) ``sharded_pq_topk`` on sift1m-pq4, rerank 400, batch 256, f32 then
   int8 LUT: recall@10 >= 0.99, identical to the plain sharded version;
   (d) ``ShardedSparseSearchEngine`` on sparse1m, batch 256 (near-ties
   excused); (e) ``ShardedStreamingSearcher`` on phase 18's f16 stream
   file and the tombstoned file with the filter, bit-identical to the
   resident sharded search; (f) ``DistributedSearcher`` in a world of one
   NCCL rank, then in two gloo ranks (this script with ``--p19-rank``,
   a timeout each) sharing cuda:0, 2 shards each, each holding only its
   rows; every answer identical to (a).
20. the examples (``examples/torch_*.py``), each through its ``main()`` on
   the card (``sharded_search`` with 4 shards on cuda:0, ``multihost`` as
   two gloo ranks of its own sharing the card), each count at 0 before
   and read after, while the same examples run with ``--device cpu`` (the
   kernels' plain versions) in a process of their own: every printed line
   of the card's run equal to the CPU's once times, rates, paths and
   device names are masked (``examples/_answer_lines.py``; the L2 values
   within one unit of their last digit, the PQ and IVF-PQ lines within
   ``P20_BAND``), every integer answer identical (but for the IVF index
   that ``similarity_search`` trains on the card), and each example's wall
   on both; ``large_dataset --size 2.5`` (873,813 x 768 f32, 2.68 GB on the
   card, its phases timed by ``PhaseTimer``) with its top-10 held to
   ``fused_topk_reference`` by phase 2's rule and its recall@10 (>= 0.99)
   to a float64 oracle on the card, and one more search traced by
   ``utils.device_trace`` (its kernels on the card in the Chrome trace);
   then ``dryrun_multichip(4)`` on cuda:0 x 4 (seven checks against the
   float64 oracle, two gloo ranks).

The second-to-last line is a JSON object describing each kernel (with its
bound from the H100 SXM data sheet: 67 TFLOP/s f32, counting an FMA as two
operations, 989 TFLOP/s dense bf16 for the bf16x3 variant, 1,979 TOP/s
dense int8 for the integer variant, and 3.35 TB/s; K2's int8 LUT the lesser
of its CUDA-core and tensor-core bounds); the last line is
``{"ok": true, "device": {...}}``. Imports nothing of JAX.
"""

from __future__ import annotations

import contextlib
import json
import os
import shutil
import subprocess
import sys
import tempfile
import threading
import time
import warnings
from concurrent.futures import ThreadPoolExecutor

import numpy as np

N_MAIN, D_MAIN = 1_000_000, 128
SEED = 7
CSRC = "metrovector_tpu_torch/ops/csrc/"
KERNEL_SOURCE = CSRC + "topk_kernel.cu"
KERNEL_REPLACES = "metrovector_tpu/ops/topk_kernel.py:741"
# H100 SXM data sheet at 700 W: the floor of a
# kernel's time is the larger of its FLOPs over the f32 rate and its bytes
# (each input read once, each output written once) over the HBM rate.
F32_FLOPS, HBM_BYTES = 67e12, 3.35e12


def bound(flops: float, nbytes: float) -> tuple[float, str]:
    """(bound_ms, bound_by) of a kernel's work."""
    t_ops, t_bytes = flops / F32_FLOPS * 1e3, nbytes / HBM_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


_T0 = time.perf_counter()


def say(*parts) -> None:
    """Print a line; a phase's closing line also gets the seconds since the
    script started, so the run's time splits by phase."""
    if parts and str(parts[0]).startswith("phase "):
        parts += (f"[{time.perf_counter() - _T0:.1f} s]",)
    print(*parts, flush=True)


def phase_device(torch) -> tuple[str, str]:
    if not torch.cuda.is_available():
        raise RuntimeError("torch.cuda.is_available() is False: no CUDA card")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    name = torch.cuda.get_device_name(0)
    say(smi)
    say(f"phase 0 device: ok ({name}, torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}, {torch.cuda.device_count()} card(s))")
    return name, smi.splitlines()[0]


def phase_build() -> str:
    """Builds the package's kernels and, beside them, phase 15's counting
    variant of the integer scan (tools/wgmma_scan_profile.py: only the
    sources its edits reach, linked with the package's other objects), so
    that no build runs while a later phase times. Returns the variant's
    root."""
    import wgmma_scan_profile

    from metrovector_tpu_torch.ops import _build

    t0 = time.perf_counter()
    started = wgmma_scan_profile.start_seed_counts()
    try:
        _build.load()
        dt = time.perf_counter() - t0
        wgmma_scan_profile.link_seed_counts(started)
    finally:
        wgmma_scan_profile.stop(started)
    say(f"phase 1 build: ok ({dt:.2f} s, {_build.build_dir()}; phase 15's counting "
        f"variant, {len(started[1])} sources recompiled beside it, linked at "
        f"{time.perf_counter() - t0:.2f} s)")
    return started[0]


def _f64_scores(q, x, norms, metric):
    """Exact scores in float64 on the host, in the kernel's convention."""
    from metrovector_tpu_torch import DistanceMetric

    dots = q.astype(np.float64) @ x.astype(np.float64).T
    if metric == DistanceMetric.L2:
        return 2.0 * dots - norms.astype(np.float64)[None, :]
    if metric == DistanceMetric.COSINE:
        return dots / np.sqrt(np.maximum(norms.astype(np.float64), 1e-30))[None, :]
    return dots


def _compare(got, ref, exact, tol, exact_scores, what):
    """Kernel (got) vs plain (ref) results of one case. Returns the largest
    finite score difference."""
    s_k, i_k = (t.cpu().numpy() for t in got)
    s_r, i_r = (t.cpu().numpy() for t in ref)
    if exact:
        if not (np.array_equal(i_k, i_r) and np.array_equal(s_k, s_r)):
            raise AssertionError(f"{what}: kernel differs from plain on exact data")
        return 0.0
    if not np.array_equal(i_k == -1, i_r == -1):
        raise AssertionError(f"{what}: unfilled slots differ")
    fin = i_r >= 0
    with np.errstate(invalid="ignore"):
        diff = np.where(fin, np.abs(s_k - s_r), 0.0)
    if (diff > tol[:, None]).any():
        raise AssertionError(f"{what}: score difference {diff.max()} above tolerance")
    for r in range(i_k.shape[0]):
        odd = set(i_k[r][i_k[r] >= 0]) ^ set(i_r[r][i_r[r] >= 0])
        if odd:
            boundary = s_r[r][fin[r]][-1]
            near = np.abs(exact_scores[r, sorted(odd)] - boundary) <= tol[r]
            if not near.all():
                raise AssertionError(f"{what}: query {r} differs outside the tie band")
    return float(diff.max())


def _one_case(torch, dev, kind, q, db, x, norms_host, num_valid, mask, k,
              metric):
    """Run kernel and plain on one case and compare them."""
    from metrovector_tpu_torch import DistanceMetric
    from metrovector_tpu_torch.ops.topk_kernel import (
        fused_topk, fused_topk_reference,
    )

    nq, d = q.shape
    n = x.shape[0]
    qd = torch.from_numpy(q).to(dev)
    norms = torch.from_numpy(norms_host).to(dev)
    vm = None if mask is None else torch.from_numpy(mask).to(dev)
    got = fused_topk(qd, db, norms, num_valid, k, metric, vm)
    ref = fused_topk_reference(qd, db, norms, num_valid, k, metric, vm)
    if metric == DistanceMetric.COSINE:
        tol = np.full(nq, 4 * d * 2.0**-24 + 2.0**-22)
    else:
        tol = (4 * d * 2.0**-24 * np.linalg.norm(q, axis=1)
               * np.sqrt(norms_host.max()))
    scores = _f64_scores(q, x, norms_host, metric)
    live = np.arange(n) < num_valid
    if mask is not None:
        live &= mask != 0
    scores[:, ~live] = -np.inf
    i_k = got[1].cpu().numpy()
    if (i_k[:, min(k, int(live.sum())):] != -1).any():
        raise AssertionError("slots beyond the unmasked rows are not -1")
    exact = kind == "integer" and metric != DistanceMetric.COSINE
    what = (f"{kind} {db.dtype} {metric.name} Q={nq} k={k} "
            f"num_valid={num_valid} mask={mask is not None}")
    return _compare(got, ref, exact, tol, scores, what)


def phase_kernel_vs_plain(torch, dev) -> tuple[float, int]:
    """Every combination of data kind, corpus dtype, metric, Q and k; the
    mask and num_valid variant rotates with the case number; then k above
    the rows left after masking. Tolerance on float data: two f32 dot
    products of length D each err by at most D*2^-24*|q||x|, L2 doubles the
    dot, so |kernel - plain| <= 4*D*2^-24*|q|*max|x|; for cosine (|q| = 1,
    x scaled by 1/|x|) 4*D*2^-24 + 2^-22. Integer data in [0, 255] makes
    every L2 and IP score exact in f32: there the two must be identical."""
    from metrovector_tpu_torch import DistanceMetric
    from metrovector_tpu_torch.ops.topk_kernel import fused_topk

    rng = np.random.default_rng(SEED)
    n, d = 3001, 128  # a multiple of no tile (32 queries, 256 rows, 16 dims)
    metrics = (DistanceMetric.L2, DistanceMetric.INNER_PRODUCT,
               DistanceMetric.COSINE)
    max_err, cases = 0.0, 0
    for kind in ("integer", "normal"):
        if kind == "integer":
            x_host = rng.integers(0, 256, (n, d)).astype(np.float32)
            q_host = rng.integers(0, 256, (256, d)).astype(np.float32)
        else:
            x_host = rng.standard_normal((n, d)).astype(np.float32)
            q_host = rng.standard_normal((256, d)).astype(np.float32)
        mask = (rng.random(n) > 0.2).astype(np.float32)
        for dt in (torch.float32, torch.float16, torch.bfloat16):
            db = torch.from_numpy(x_host).to(dev).to(dt)
            x = db.float().cpu().numpy()  # the values as stored
            norms = (x.astype(np.float64) ** 2).sum(1).astype(np.float32)
            for metric in metrics:
                q_all = q_host
                if metric == DistanceMetric.COSINE:
                    q_all = (q_host / np.maximum(np.linalg.norm(
                        q_host, axis=1, keepdims=True), 1e-30)).astype(np.float32)
                for nq in (1, 37, 256):
                    q = np.ascontiguousarray(q_all[:nq])
                    for k in (1, 10, 100, 256):
                        variant = cases % 4
                        num_valid = n - 77 if variant >= 2 else n
                        vm = mask if variant % 2 else None
                        max_err = max(max_err, _one_case(
                            torch, dev, kind, q, db, x, norms, num_valid, vm,
                            k, metric))
                        cases += 1
                    for k in (100, 256):  # k > num_valid after masking
                        max_err = max(max_err, _one_case(
                            torch, dev, kind, q, db, x, norms, 60, mask, k,
                            metric))
                        cases += 1
    cases += _k1_split_cases(torch, dev, rng)
    c1_cases, c1_err = _f16_default_cases(torch, dev, rng)
    cases += c1_cases
    max_err = max(max_err, c1_err)
    empty = torch.empty((0, d), device=dev)  # an empty corpus launches nothing
    s_e, i_e = fused_topk(torch.ones((3, d), device=dev), empty,
                          torch.empty(0, device=dev), 0, 5, DistanceMetric.L2)
    if not (torch.isneginf(s_e).all() and (i_e == -1).all()):
        raise AssertionError("an empty corpus did not give (-inf, -1) slots")
    torch.cuda.synchronize()
    say(f"phase 2 kernel vs plain: ok ({cases} cases, max |score diff| "
        f"{max_err:.3g})")
    return max_err, cases


def _f16_default_cases(torch, dev, rng) -> tuple[int, float]:
    """An f16 space at precision "default" as the engine holds it: bf16 rows
    on the card and f32 queries from prepare_queries that bf16 cannot hold
    (the reference rounds queries through bf16 only for f32 spaces). K1 on
    them against its plain version, within phase 2's band, over the three
    metrics at k 10 and 100. Returns (cases, max |score diff|)."""
    from metrovector_tpu_torch import DataType, DistanceMetric
    from metrovector_tpu_torch.engine import DeviceSpace

    n, d = 3001, 128
    x_f16 = rng.standard_normal((n, d)).astype(np.float16)
    db = torch.from_numpy(x_f16).to(dev).to(torch.bfloat16)
    x = db.float().cpu().numpy()
    norms = (x.astype(np.float64) ** 2).sum(1).astype(np.float32)
    q_raw = rng.standard_normal((37, d)).astype(np.float32)
    cases, err = 0, 0.0
    for metric in (DistanceMetric.L2, DistanceMetric.INNER_PRODUCT,
                   DistanceMetric.COSINE):
        sp = DeviceSpace(db, torch.from_numpy(norms).to(dev), n, d, metric,
                         dtype=DataType.FLOAT16, precision="default")
        q = sp.prepare_queries(q_raw).qdev.cpu().numpy()
        if np.array_equal(q, torch.from_numpy(q).bfloat16().float().numpy()):
            raise AssertionError("f16 'default' queries were rounded through bf16")
        for k in (10, 100):
            err = max(err, _one_case(torch, dev, "normal", q, db, x, norms, n,
                                     None, k, metric))
            cases += 1
    return cases, err


SPLIT_N = 200_003  # rows of the split cases: long splits at every batch


def _twin_rows(rng, n, d, hi, distinct=3000):
    """n integer rows in [0, hi) drawn from `distinct` base rows: every row
    has twins in other splits, so exact ties decide across splits."""
    return rng.integers(0, hi, (distinct, d)).astype(np.float32)[
        rng.integers(0, distinct, n)]


def _twice_identical(torch, fn, args, ref, what) -> None:
    """Two launches on the same inputs, each identical to the plain version:
    the race of the splits over the shared bar may change the work, never
    the answer."""
    for _ in range(2):
        _identical(torch, fn(*args), ref, what)


def _k1_split_cases(torch, dev, rng) -> int:
    """fused_topk on 200,003 integer rows with twins across splits, f32/f16/
    bf16 corpora at D in {128, 100, 1536}, batches 1, 33, 37 and 255 (none
    fills a tile), k in {10, 100, 256, 257}, with num_valid ending inside a
    split and a mask that empties whole splits; each case run twice and
    identical to the plain version. Returns the cases run."""
    from metrovector_tpu_torch import DistanceMetric
    from metrovector_tpu_torch.ops.topk_kernel import (
        fused_topk, fused_topk_reference,
    )

    n, cases = SPLIT_N, 0
    mask = np.ones(n, np.float32)
    mask[40_000:120_000] = 0  # every split that starts in here is empty
    mask_d = torch.from_numpy(mask).to(dev)
    for d in (128, 100, 1536):
        x = torch.from_numpy(_twin_rows(rng, n, d, 16)).to(dev)
        norms = (x.double() ** 2).sum(1).float()
        q_host = rng.integers(0, 16, (255, d)).astype(np.float32)
        for dt in (torch.float32, torch.float16, torch.bfloat16):
            db = x.to(dt)
            for nq in (1, 33, 37, 255):
                q = torch.from_numpy(q_host[:nq]).to(dev)
                for k in (10, 100, 256, 257):
                    metric = (DistanceMetric.L2, DistanceMetric.INNER_PRODUCT)[cases % 2]
                    variant = (cases + cases // 4) % 4
                    num_valid = n - 70_001 if variant & 1 else n
                    args = (q, db, norms, num_valid, k, metric,
                            mask_d if variant & 2 else None)
                    _twice_identical(
                        torch, fused_topk, args, fused_topk_reference(*args),
                        f"fused_topk split case {dt} D={d} Q={nq} k={k} "
                        f"{metric.name} num_valid={num_valid} mask={bool(variant & 2)}")
                    cases += 1
            del db
        del x, norms
        torch.cuda.empty_cache()
    return cases


def _oracle_topk(q, x64, norms64, k):
    """bench.py's oracle: float64 L2, ascending, ties to the lowest row."""
    out = np.empty((q.shape[0], k), np.int64)
    for c0 in range(0, q.shape[0], 32):
        qc = q[c0 : c0 + 32].astype(np.float64)
        d2 = norms64[None, :] - 2.0 * (qc @ x64.T)
        kth = np.partition(d2, k - 1, axis=1)[:, k - 1]
        for r in range(qc.shape[0]):
            cand = np.nonzero(d2[r] <= kth[r])[0]
            order = np.lexsort((cand, d2[r, cand]))
            out[c0 + r] = cand[order][:k]
    return out


def phase_main_path(torch, dev, card, keep=None):
    from metrovector_tpu_torch import Builder, DistanceMetric, Reader, SearchEngine
    from metrovector_tpu_torch.ops.topk_kernel import (
        fused_topk, fused_topk_reference,
    )
    from metrovector_tpu_torch.utils.timing import cuda_ms, sync_time

    rng = np.random.default_rng(SEED)
    x = rng.integers(0, 256, (N_MAIN, D_MAIN)).astype(np.float32)
    tmp = tempfile.TemporaryDirectory()
    path = os.path.join(keep or tmp.name, "sift1m_like.mvt")
    t0 = time.perf_counter()
    b = Builder()
    b.add_vector_space("sift", dim=D_MAIN, metric=DistanceMetric.L2)
    b.add_vectors("sift", x)
    b.build().save(path)
    t_build = time.perf_counter() - t0
    t0 = time.perf_counter()
    space = Reader.open(path).vector_space("sift")
    engine = SearchEngine(space, device="cuda")
    torch.cuda.synchronize()
    t_upload = time.perf_counter() - t0
    say(f"  file {N_MAIN}x{D_MAIN} f32 written in {t_build:.1f} s; "
        f"Reader.open + upload {t_upload:.2f} s "
        f"({engine.space.nbytes / 2**20:.0f} MiB on the card)")

    x64 = x.astype(np.float64)
    norms64 = (x64 ** 2).sum(1)
    runs = [(32, 10), (64, 10), (128, 10), (256, 10), (32, 100)]
    queries = {run: rng.integers(0, 256, (run[0], D_MAIN)).astype(np.float32)
               for run in runs}
    results = {}
    fused_topk.launches = 0
    for run in runs:
        before = fused_topk.launches
        results[run] = engine.search(queries[run], k=run[1])
        if fused_topk.launches != before + 1:
            raise AssertionError("search() did not launch the kernel")
    launches = fused_topk.launches
    for (nq, k), res in results.items():
        want = _oracle_topk(queries[(nq, k)], x64, norms64, k)
        recall = np.mean([len(set(res.indices[r]) & set(want[r])) / k
                          for r in range(nq)])
        same_order = np.array_equal(res.indices, want)
        say(f"  batch={nq} k={k}: recall@{k} = {recall:.3f} "
            f"(order identical to the oracle: {same_order})")
        if recall != 1.0:
            raise AssertionError(f"recall@{k} = {recall} at batch {nq}")
    sp = engine.space
    for run in ((256, 10), (32, 100)):
        qd = torch.from_numpy(queries[run]).to(dev)
        s_r, i_r = fused_topk_reference(qd, sp.data, sp.norms, sp.num_valid,
                                        run[1], DistanceMetric.L2)
        if not (np.array_equal(results[run].indices, i_r.cpu().numpy())
                and np.array_equal(results[run].scores, s_r.cpu().numpy())):
            raise AssertionError(f"main path differs from the plain version at {run}")

    times = {}
    iters = 20
    for nq, k in runs:
        inputs = [torch.from_numpy(
            rng.integers(0, 256, (nq, D_MAIN)).astype(np.float32)).to(dev)
            for _ in range(iters)]

        def kern(q, k=k):
            return fused_topk(q, sp.data, sp.norms, sp.num_valid, k,
                              DistanceMetric.L2)

        def plain(q, k=k):
            return fused_topk_reference(q, sp.data, sp.norms, sp.num_valid, k,
                                        DistanceMetric.L2)

        kern(inputs[0])
        plain(inputs[0])
        p1 = cuda_ms(plain, inputs, dev)
        k1 = cuda_ms(kern, inputs, dev)
        k2 = cuda_ms(kern, inputs, dev)
        p2 = cuda_ms(plain, inputs, dev)
        e2e = np.median([
            sync_time(engine.search, q.cpu().numpy(), k=k, device=dev)[0]
            for q in inputs])
        kms, pms = (k1 + k2) / 2, (p1 + p2) / 2
        times[(nq, k)] = (kms, pms)
        say(f"  timing batch={nq} k={k}: kernel {kms:.4f} ms/batch "
            f"({nq / kms * 1e3:.0f} QPS; runs {k1:.4f}, {k2:.4f}) | plain "
            f"{pms:.4f} ms/batch ({nq / pms * 1e3:.0f} QPS; runs {p1:.4f}, "
            f"{p2:.4f}) | search() end to end p50 {e2e * 1e3:.4f} ms | {card}")
    # A yardstick for the scan alone: one cuBLAS product of the batch-256
    # queries with the corpus, in full f32 (TF32 off); it selects nothing,
    # so it is not fused_topk's library_ms.
    xt = sp.data.T
    qs = [torch.from_numpy(rng.integers(0, 256, (256, D_MAIN)).astype(np.float32)).to(dev)
          for _ in range(iters)]
    torch.mm(qs[0], xt)
    mm_ms = cuda_ms(lambda q: torch.mm(q, xt), qs, dev)
    times["mm"] = mm_ms
    say(f"  yardstick: torch.mm [256,{D_MAIN}] x [{D_MAIN},{N_MAIN}] f32 (TF32 off) "
        f"{mm_ms:.4f} ms; fused_topk batch=256 k=10 {times[(256, 10)][0]:.4f} ms | {card}")
    del qs
    say(f"phase 3 main path: ok (recall 1.000 at k=10 and k=100, "
        f"fused_topk launches {launches})")
    return engine, tmp, launches, times


def phase_filters_ids(torch, engine):
    from metrovector_tpu_torch import Builder, SearchEngine

    rng = np.random.default_rng(SEED + 1)
    q = rng.integers(0, 256, (1, D_MAIN)).astype(np.float32)
    base = engine.search(q, k=10)
    top1 = int(base.indices[0, 0])
    mask = np.ones(engine.space.num_valid, bool)
    mask[top1] = False
    filtered = engine.search(q, k=10, filter_mask=mask)
    if top1 in filtered.indices or not np.array_equal(
            filtered.indices[0, :9], base.indices[0, 1:]):
        raise AssertionError("filter_mask did not exclude exactly the top-1")
    prepared = engine.search(q, k=10, filter_mask=engine.prepare_filter(mask))
    if not np.array_equal(prepared.indices, filtered.indices):
        raise AssertionError("PreparedFilter differs from the raw mask")
    engine.space.delete_rows([top1])
    after = engine.search(q, k=10)
    if not np.array_equal(after.indices, filtered.indices):
        raise AssertionError("delete_rows did not remove the top-1")

    n = 5000
    x = rng.integers(0, 256, (n, D_MAIN)).astype(np.float32)
    ids = (np.arange(n, dtype=np.uint64) * np.uint64(7919)
           + np.uint64(10**12))[rng.permutation(n)]
    b = Builder()
    b.add_vector_space("v", dim=D_MAIN)
    b.add_vectors("v", x, ids=ids)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "ids.mvt")
        b.build().save(path)
        small = SearchEngine.open(path, device="cuda")
        res = small.search(x[:8], k=5)
        if not (np.array_equal(res.indices[:, 0], np.arange(8))
                and np.array_equal(res.ids, ids[res.indices])):
            raise AssertionError("the ID column did not come back")
        small.space.delete_rows(ids=[res.ids[0, 0]])
        if 0 in small.search(x[:1], k=5).indices:
            raise AssertionError("delete_rows by id did not remove the row")
    say("phase 4 filters, tombstones, ids: ok")


def phase_serving(engine):
    from metrovector_tpu_torch import MicroBatcher

    rng = np.random.default_rng(SEED + 2)
    qs = rng.integers(0, 256, (64, D_MAIN)).astype(np.float32)
    want = engine.search(qs, k=10)
    with MicroBatcher(engine, k=10, max_batch=64, max_wait_ms=5.0) as mb:
        with ThreadPoolExecutor(64) as pool:
            futs = [pool.submit(lambda v: mb.submit(v).result(timeout=120), qs[i])
                    for i in range(64)]
            got = [f.result(timeout=180) for f in futs]
        stats = mb.stats()
    for i, r in enumerate(got):
        if not (np.array_equal(r.indices[0], want.indices[i])
                and np.array_equal(r.scores[0], want.scores[i])
                and np.array_equal(r.ids[0], want.ids[i])):
            raise AssertionError(f"MicroBatcher answer {i} differs from search()")
    say(f"phase 5 serving: ok (64 requests in {stats.batches} batches, "
        f"occupancy {stats.occupancy:.2f}, p50 {stats.p50_ms:.2f} ms)")


ADC_CONFIGS = (  # (codes, m, ksub, packed4)
    ("uint8", 16, 256, False), ("uint8", 8, 64, False),
    ("packed4", 32, 16, True), ("packed4", 5, 16, True),
)


def _adc_scores64(lut64, codes, m, ksub, rnorms, metric, live):
    """float64 ADC scores [Q, N] of the LUT both versions use; -inf where
    not live."""
    from metrovector_tpu_torch import DistanceMetric

    s = np.zeros((lut64.shape[0], codes.shape[0]))
    for j in range(m):
        s += lut64[:, j * ksub + codes[:, j].astype(np.int64)]
    r64 = rnorms.astype(np.float64)
    if metric == DistanceMetric.L2:
        s = 2.0 * s - r64[None, :]
    elif metric == DistanceMetric.COSINE:
        s = s / np.sqrt(np.maximum(r64, 1e-30))[None, :]
    s[:, ~live] = -np.inf
    return s


def _adc_band(lut64, m, ksub, metric, rnorms, scores64):
    """Two f32 sums of m LUT entries differ by at most
    2(m-1)2^-24 sum_j max_c |LUT[q,j,c]|; L2 doubles it, cosine scales it
    by 1/min|x^|; the epilogue adds a rounding of the score."""
    from metrovector_tpu_torch import DistanceMetric

    base = (2 * (m - 1) * 2.0**-24
            * np.abs(lut64).reshape(len(lut64), m, ksub).max(2).sum(1))
    if metric == DistanceMetric.L2:
        base = 2 * base
    elif metric == DistanceMetric.COSINE:
        base = base / np.sqrt(max(float(rnorms.min()), 1e-30))
    fin = np.where(np.isfinite(scores64), np.abs(scores64), 0.0)
    return base + 4 * 2.0**-24 * fin.max(1)


def phase_adc_vs_plain(torch, dev) -> tuple[float, int]:
    """Every combination of data kind, code layout, LUT type, metric, Q
    and k; the mask and num_valid variant rotates with the case number;
    then k above the rows left after masking. Integer-valued queries and
    codebooks make every LUT entry and sum exact: there the kernel and the
    plain version must be identical (both add the m entries of a row in
    ascending order in f32, so they agree on float data too, but only the
    band of _adc_band is required there)."""
    from metrovector_tpu_torch import DistanceMetric
    from metrovector_tpu_torch.index.pq import pack_codes4
    from metrovector_tpu_torch.ops.adc_kernel import (
        adc_lut, fused_adc_topk, fused_adc_topk_reference,
    )

    rng = np.random.default_rng(SEED + 6)
    n, dsub = 3001, 4
    metrics = (DistanceMetric.L2, DistanceMetric.INNER_PRODUCT,
               DistanceMetric.COSINE)
    max_err, cases, identical = 0.0, 0, 0
    for kind in ("integer", "normal"):
        for layout, m, ksub, packed in ADC_CONFIGS:
            d = m * dsub
            if kind == "integer":
                books = rng.integers(0, 8, (m, ksub, dsub)).astype(np.float32)
                q_host = rng.integers(0, 8, (256, d)).astype(np.float32)
            else:
                books = rng.standard_normal((m, ksub, dsub)).astype(np.float32)
                q_host = rng.standard_normal((256, d)).astype(np.float32)
            codes = rng.integers(0, ksub, (n, m)).astype(np.uint8)
            recon = np.concatenate([books[j][codes[:, j]] for j in range(m)], 1)
            rnorms = (recon.astype(np.float64) ** 2).sum(1).astype(np.float32)
            mask = (rng.random(n) > 0.2).astype(np.float32)
            codes_d = torch.from_numpy(pack_codes4(codes) if packed else codes).to(dev)
            books_d = torch.from_numpy(books).to(dev)
            rn_d = torch.from_numpy(rnorms).to(dev)
            mask_d = torch.from_numpy(mask).to(dev)
            for exact_lut in (True, False):
                for metric in metrics:
                    q_all = q_host
                    if metric == DistanceMetric.COSINE:
                        q_all = (q_host / np.maximum(np.linalg.norm(
                            q_host, axis=1, keepdims=True), 1e-30)).astype(np.float32)
                    for nq in (1, 37, 256):
                        qd = torch.from_numpy(np.ascontiguousarray(q_all[:nq])).to(dev)
                        lut64 = adc_lut(qd, books_d, exact_lut).double().cpu().numpy()
                        # every row's float64 score once; each run masks it
                        all64 = _adc_scores64(lut64, codes, m, ksub, rnorms, metric,
                                              np.ones(n, bool))
                        runs = []
                        for k in (1, 10, 400, 1024):
                            variant = cases % 4
                            runs.append((k, n - 77 if variant >= 2 else n,
                                         variant % 2 == 1))
                            cases += 1
                        runs.append((400, 60, True))  # k > live rows
                        cases += 1
                        for k, num_valid, masked in runs:
                            vm = mask_d if masked else None
                            args = (qd, codes_d, books_d, rn_d, num_valid, k,
                                    metric, vm, exact_lut, packed)
                            got = fused_adc_topk(*args)
                            ref = fused_adc_topk_reference(*args)
                            live = np.arange(n) < num_valid
                            if masked:
                                live &= mask != 0
                            scores = np.where(live[None, :], all64, -np.inf)
                            i_k = got[1].cpu().numpy()
                            if (i_k[:, min(k, int(live.sum())):] != -1).any():
                                raise AssertionError("slots beyond the live rows are not -1")
                            exact = kind == "integer" and metric != DistanceMetric.COSINE
                            what = (f"ADC {kind} {layout} m={m} ksub={ksub} "
                                    f"{'f32' if exact_lut else 'bf16'} LUT "
                                    f"{metric.name} Q={nq} k={k} "
                                    f"num_valid={num_valid} mask={masked}")
                            max_err = max(max_err, _compare(
                                got, ref, exact,
                                _adc_band(lut64, m, ksub, metric, rnorms, scores),
                                scores, what))
                            identical += bool(torch.equal(got[0], ref[0])
                                              and torch.equal(got[1], ref[1]))
    split_cases = _k2_split_cases(torch, dev, rng)
    cases += split_cases
    identical += split_cases
    torch.cuda.synchronize()
    say(f"phase 6 ADC kernel vs plain: ok ({cases} cases, {identical} "
        f"bit-identical, max |score diff| {max_err:.3g})")
    return max_err, cases


def _k2_split_cases(torch, dev, rng) -> int:
    """fused_adc_topk on 200,003 rows of codes with twins across splits,
    4-bit m=32 and 8-bit m=16 codes, f32 and bf16 LUTs, integer and float
    codebooks, batches 1, 33, 37 and 255, k in {1, 10, 400}, with num_valid
    ending inside a split and a mask that empties whole splits: identical to
    the plain version on float data too, and run twice on integer data.
    Returns the cases run."""
    from metrovector_tpu_torch import DistanceMetric
    from metrovector_tpu_torch.index.pq import pack_codes4
    from metrovector_tpu_torch.ops.adc_kernel import (
        fused_adc_topk, fused_adc_topk_reference,
    )

    n, cases = SPLIT_N, 0
    metrics = (DistanceMetric.L2, DistanceMetric.INNER_PRODUCT,
               DistanceMetric.COSINE)
    mask = np.ones(n, np.float32)
    mask[40_000:120_000] = 0
    mask_d = torch.from_numpy(mask).to(dev)
    for kind in ("integer", "normal"):
        for packed, m, ksub in ((True, 32, 16), (False, 16, 256)):
            if kind == "integer":
                books = rng.integers(0, 8, (m, ksub, 4)).astype(np.float32)
                q_host = rng.integers(0, 8, (255, m * 4)).astype(np.float32)
            else:
                books = rng.standard_normal((m, ksub, 4)).astype(np.float32)
                q_host = rng.standard_normal((255, m * 4)).astype(np.float32)
            codes = rng.integers(0, ksub, (3000, m)).astype(np.uint8)[
                rng.integers(0, 3000, n)]
            recon = np.concatenate([books[j][codes[:, j]] for j in range(m)], 1)
            rn = torch.from_numpy((recon.astype(np.float64) ** 2).sum(1).astype(
                np.float32)).to(dev)
            codes_d = torch.from_numpy(pack_codes4(codes) if packed else codes).to(dev)
            books_d = torch.from_numpy(books).to(dev)
            for exact_lut in (True, False):
                for nq in (1, 33, 37, 255):
                    for k in (1, 10, 400):
                        metric = metrics[cases % 3]
                        q = q_host[:nq]
                        if metric == DistanceMetric.COSINE:
                            q = q / np.maximum(np.linalg.norm(q, axis=1, keepdims=True), 1e-30)
                        variant = (cases + cases // 3) % 4
                        num_valid = n - 70_001 if variant & 1 else n
                        args = (torch.from_numpy(np.ascontiguousarray(q, np.float32)).to(dev),
                                codes_d, books_d, rn, num_valid, k, metric,
                                mask_d if variant & 2 else None, exact_lut, packed)
                        what = (f"fused_adc_topk split case {kind} m={m} ksub={ksub} "
                                f"{'f32' if exact_lut else 'bf16'} LUT Q={nq} k={k} "
                                f"{metric.name} num_valid={num_valid} "
                                f"mask={bool(variant & 2)}")
                        ref = fused_adc_topk_reference(*args)
                        if kind == "integer":
                            _twice_identical(torch, fused_adc_topk, args, ref, what)
                        else:
                            _identical(torch, fused_adc_topk(*args), ref, what)
                        cases += 1
    return cases


_BITS = {torch_name: bits for torch_name, bits in (
    ("float32", "int32"), ("float16", "int16"), ("bfloat16", "int16"),
    ("int8", "int8"), ("uint8", "uint8"), ("int32", "int32"))}


def phase_gather_vs_plain(torch, dev) -> tuple[float, float]:
    """gather_rows against db[clamp(idx)] bit for bit, over dtypes, an odd
    row width and an aligned one, int32 and int64 indices with negative
    and >= N entries. rescore_candidates against its plain version in
    both tie modes, with -1 candidates and a corpus of duplicate rows:
    identical on integer data (L2/IP); within the f32 dot band of phase 2
    on float data and for cosine."""
    from metrovector_tpu_torch import DistanceMetric
    from metrovector_tpu_torch.ops.gather_kernel import (
        gather_rows, gather_rows_reference, rescore_candidates,
        rescore_candidates_reference,
    )

    rng = np.random.default_rng(SEED + 7)
    n = 3001
    gathers, gather_err = 0, 0.0
    for name, bits in _BITS.items():
        dt = getattr(torch, name)
        bdt = getattr(torch, bits)
        for d, offset in ((128, 0), (13, 0), (13, 1)):
            src = torch.from_numpy(rng.standard_normal((n + offset, d)).astype(
                np.float32) * 100)
            db = src.to(dt).to(dev)[offset:]  # offset 1: an unaligned start
            for idx_dt in (torch.int32, torch.int64):
                idx = torch.cat([torch.from_numpy(rng.integers(0, n, 5000)),
                                 torch.tensor([-1, -7, n, n + 5, 2**30])]).to(idx_dt).to(dev)
                got = gather_rows(db, idx)
                ref = gather_rows_reference(db, idx)
                want = db[idx.long().clamp(0, n - 1)]
                if not (torch.equal(got.view(bdt), ref.view(bdt))
                        and torch.equal(got.view(bdt), want.view(bdt))):
                    raise AssertionError(f"gather_rows differs from db[idx] "
                                         f"({name}, D={d}, offset {offset})")
                gather_err = max(gather_err, float(
                    (got.double() - want.double()).abs().max()))
                gathers += 1

    metrics = (DistanceMetric.L2, DistanceMetric.INNER_PRODUCT,
               DistanceMetric.COSINE)
    d = 128
    max_err, cases = 0.0, 0
    for kind in ("integer", "normal"):
        base = (rng.integers(0, 256, (n // 4, d)) if kind == "integer"
                else rng.standard_normal((n // 4, d))).astype(np.float32)
        x = base[rng.integers(0, n // 4, n)]  # duplicate rows: exact ties
        q_host = (rng.integers(0, 256, (256, d)) if kind == "integer"
                  else rng.standard_normal((256, d))).astype(np.float32)
        xd = torch.from_numpy(x).to(dev)
        norms_host = (x.astype(np.float64) ** 2).sum(1).astype(np.float32)
        norms = torch.from_numpy(norms_host).to(dev)
        for metric in metrics:
            for nq, r, k in ((1, 37, 37), (37, 400, 10), (256, 400, 10),
                             (8, 4096, 100), (256, 4096, 1)):
                q = q_host[:nq]
                cand = rng.integers(0, n, (nq, r)).astype(np.int32)
                cand[:, ::7] = -1
                cand_d = torch.from_numpy(cand).to(dev)
                qd = torch.from_numpy(np.ascontiguousarray(q)).to(dev)
                scores = _f64_scores(q, x, norms_host, metric)
                if metric == DistanceMetric.COSINE:
                    scores /= np.linalg.norm(q.astype(np.float64), axis=1,
                                             keepdims=True)
                    tol = np.full(nq, 4 * d * 2.0**-24 + 2.0**-22)
                else:
                    tol = (4 * d * 2.0**-24 * np.linalg.norm(q, axis=1)
                           * np.sqrt(norms_host.max()))
                member = np.zeros((nq, n), bool)
                np.put_along_axis(member, np.maximum(cand, 0), cand >= 0, axis=1)
                scores[~member] = -np.inf
                for tie in ("position", "row"):
                    args = (qd, xd, norms, cand_d, k, metric, tie)
                    got = rescore_candidates(*args)
                    ref = rescore_candidates_reference(*args)
                    exact = kind == "integer" and metric != DistanceMetric.COSINE
                    max_err = max(max_err, _compare(
                        got, ref, exact, tol, scores,
                        f"rescore {kind} {metric.name} Q={nq} R={r} k={k} tie={tie}"))
                    cases += 1
    split_cases, plans = _rescore_split_cases(torch, dev, rng)
    torch.cuda.synchronize()
    say(f"phase 7 gather and rescore kernels vs plain: ok ({gathers} gathers "
        f"bit-identical, max |diff| {gather_err:.3g}; {cases} rescore cases, "
        f"max |score diff| {max_err:.3g}; {split_cases} split-plan cases "
        f"identical twice, plans (merge, warp selection) {sorted(plans)})")
    return gather_err, max_err


def _rescore_split_cases(torch, dev, rng) -> tuple[int, set]:
    """rescore_candidates under every split plan rescore_plan can choose
    (one split or several; lists folded by the last block or by the merge
    tree; warp selection or a sort of the split): batches 1, 32, 256 and
    600, R from 37 to 300,000, k 10 and 100, R = k = 8192. Integer rows
    with a twin each; every query's first 8 candidates are twins of its
    last 8 (so they fall in the first and the last split), one split holds
    only -1, and candidates repeat. Both tie modes, each case run twice and
    identical to the plain version. Returns (cases, plans seen)."""
    from metrovector_tpu_torch import DistanceMetric
    from metrovector_tpu_torch.ops.gather_kernel import (
        MERGE_BLOCK, MERGE_NONE, MERGE_TREE, WARP_LIST, rescore_candidates,
        rescore_candidates_reference, rescore_plan,
    )

    n, d = 30_000, D_MAIN
    base = rng.integers(0, 256, (n // 2, d)).astype(np.float32)
    x = torch.from_numpy(np.concatenate([base, base])).to(dev)  # twins i, i + n/2
    norms = (x.double() ** 2).sum(1).float()
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    shapes = {1: ((37, 10), (400, 10), (4097, 100), (20_000, 10), (300_000, 10)),
              32: ((400, 10), (400, 100), (4097, 10), (20_000, 10), (8192, 8192)),
              256: ((400, 10), (400, 100), (4097, 10), (4097, 100)),
              600: ((400, 10), (400, 100))}
    cases, plans = 0, set()
    for nq, runs in shapes.items():
        q = torch.from_numpy(rng.integers(0, 256, (nq, d)).astype(np.float32)).to(dev)
        for r, k in runs:
            plan = rescore_plan(nq, r, k, d, sms)
            cand = rng.integers(0, n, (nq, r)).astype(np.int32)
            twins = rng.integers(0, n // 2, (nq, 8))
            cand[:, :8] = twins + n // 2
            cand[:, -8:] = twins
            if plan.splits > 2:
                cand[:, plan.split_len:2 * plan.split_len] = -1
            cand_d = torch.from_numpy(cand).to(dev)
            for tie in ("position", "row"):
                metric = (DistanceMetric.L2, DistanceMetric.INNER_PRODUCT)[cases % 2]
                args = (q, x, norms, cand_d, k, metric, tie)
                _twice_identical(torch, rescore_candidates, args,
                                 rescore_candidates_reference(*args),
                                 f"rescore split case Q={nq} R={r} k={k} {metric.name} "
                                 f"tie={tie} {plan}")
                cases += 1
            plans.add((plan.merge, plan.list_len <= WARP_LIST))
    # The last block folds only k <= WARP_LIST, so only by warp selection.
    want = {(m, w) for m in (MERGE_NONE, MERGE_TREE) for w in (True, False)}
    want.add((MERGE_BLOCK, True))
    if plans != want:
        raise AssertionError(f"split plans not all driven: {sorted(want - plans)}")
    return cases, plans


PQ_CONFIGS = (  # benchmarks/suite.py's sift1m-pq4 and sift1m-pq: (name, m, ksub, packed4)
    ("sift1m-pq4", 32, 16, True), ("sift1m-pq", 16, 256, False),
)
RERANK, K_PQ = 400, 10


def _clustered_u8_corpus(rng, n, d, ncenters=4096, spread=12.0):
    """SIFT-like rows: u8 values around cluster centers (the algebra of
    benchmarks/suite.py::_clustered_u8_corpus)."""
    centers = rng.integers(0, 256, (ncenters, d)).astype(np.float32)
    rows = centers[rng.integers(0, ncenters, n)]
    rows += rng.normal(0.0, spread, (n, d)).astype(np.float32)
    return np.clip(np.rint(rows), 0, 255).astype(np.float32)


def _pq_queries(rng, x, nq):
    """Noisy copies of corpus rows (the suite's queries), rounded so that
    every exact L2 score is an f32 integer."""
    base = x[rng.integers(0, x.shape[0], nq)]
    return np.clip(np.rint(base + rng.normal(0, 8, base.shape)), 0,
                   255).astype(np.float32)


def _recall_on_card(torch, x64, norms64, q, rows, k):
    """recall@k against a float64 oracle computed on the card. A returned
    row is a hit when its exact distance is within the k-th best, so exact
    ties at the boundary all count as right answers."""
    hits = 0
    for c0 in range(0, q.shape[0], 64):
        qd = torch.from_numpy(q[c0 : c0 + 64]).to(x64.device, torch.float64)
        d2 = norms64[None, :] - 2.0 * (qd @ x64.T)
        kth = torch.topk(d2, k, dim=1, largest=False).values[:, -1:]
        r = torch.from_numpy(rows[c0 : c0 + 64].astype(np.int64)).to(x64.device)
        got = torch.gather(d2, 1, r.clamp(min=0))
        hits += int(((got <= kth) & (r >= 0)).sum())
    return hits / (q.shape[0] * k)


def _same_candidates(torch, got, ref, lut, codes, rnorms, m, ksub, what):
    """K2 against its plain version at full size (L2): identical, or
    scores within the f32 band of phase 6 and differing rows only at
    near-ties of the last slot. Returns whether they were identical."""
    if torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1]):
        return True
    lut64 = lut.double().cpu().numpy()
    band = 4 * (m - 1) * 2.0**-24 * np.abs(lut64).reshape(
        len(lut64), m, ksub).max(2).sum(1)
    s_k, i_k = (t.cpu().numpy() for t in got)
    s_r, i_r = (t.cpu().numpy() for t in ref)
    tol = band[:, None] + 4 * 2.0**-24 * np.abs(s_r)
    if (np.abs(s_k - s_r) > tol).any():
        raise AssertionError(f"{what}: ADC scores differ beyond the band")
    for r in range(len(i_k)):
        odd = np.array(sorted(set(i_k[r]) ^ set(i_r[r])), np.int64)
        if odd.size:
            sub = codes[odd].astype(np.int64)
            s64 = 2 * sum(lut64[r, j * ksub + sub[:, j]] for j in range(m)) \
                - rnorms[odd].astype(np.float64)
            if (np.abs(s64 - s_r[r, -1]) > tol[r, -1]).any():
                raise AssertionError(f"{what}: query {r} differs outside the tie band")
    return False


def _pq_host_split(torch, dev, idx, packed, qs, host) -> dict:
    """PQIndex.search's steps one at a time (its code, unchanged, repeated
    here with a synchronize after each): host query prep and upload,
    fused_adc_topk (with its LUT), rescore_candidates, the two readbacks
    and the finalize (distances, sentinels, ids), each a host-clock median
    in ms over the batches; beside them the device ms of adc_lut, K2 and K3
    (device_ms) and the host µs of one K2 and one K3 wrapper call (the
    enqueue alone)."""
    from metrovector_tpu_torch import DistanceMetric
    from metrovector_tpu_torch.engine import ids_for_rows
    from metrovector_tpu_torch.ops.adc_kernel import adc_lut, fused_adc_topk
    from metrovector_tpu_torch.ops.distances import distances_np
    from metrovector_tpu_torch.ops.gather_kernel import rescore_candidates
    from metrovector_tpu_torch.utils.timing import device_ms

    L2 = DistanceMetric.L2
    steps = {k: [] for k in ("prep", "k2", "k3", "readback", "finalize")}

    def k2(q):
        return fused_adc_topk(q, idx.codes, idx._books, idx.recon_norms,
                              idx.num_vectors, RERANK, L2, idx.valid, True, packed)

    def k3(p):
        return rescore_candidates(p[0], idx.db, idx.db_norms, p[1], K_PQ, L2,
                                  tie="position")

    for qh in host:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        q = np.ascontiguousarray(qh, np.float32)
        qnorms = np.einsum("ij,ij->i", q, q, dtype=np.float64).astype(np.float32)
        qdev = torch.from_numpy(q).to(dev)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        s, i = k2(qdev)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        s, i = k3((qdev, i))
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        s, i = s.cpu().numpy(), i.cpu().numpy()
        t4 = time.perf_counter()
        dist = distances_np(s, L2, qnorms)
        dist = np.where(i >= 0, dist, np.inf)
        ids_for_rows(idx.host_ids, i)
        t5 = time.perf_counter()
        for key, a, b in (("prep", t0, t1), ("k2", t1, t2), ("k3", t2, t3),
                          ("readback", t3, t4), ("finalize", t4, t5)):
            steps[key].append((b - a) * 1e3)
    out = {key: float(np.median(v)) for key, v in steps.items()}
    lut = lambda q: adc_lut(q, idx._books, True)  # noqa: E731
    lut(qs[0])
    out["lut_device"] = device_ms(lut, qs, dev)
    out["k2_device"] = device_ms(k2, qs, dev)
    pairs = [(q, k2(q)[1]) for q in qs]
    out["k3_device"] = device_ms(k3, pairs, dev)
    for key, fn, inputs in (("k2_host_us", k2, qs), ("k3_host_us", k3, pairs)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for x in inputs:
            fn(x)
        out[key] = (time.perf_counter() - t0) / len(inputs) * 1e6
        torch.cuda.synchronize()
    return out


def _int8_lut_searches(torch, dev, card, name, route, idx, x64, norms64,
                       queries) -> dict:
    """``name`` (phase 8's sift1m-pq4 or sift1m-pq index) with the int8 LUT
    on its ``route`` (ops/adc_kernel.py::int8_lut_route: "mma", the
    tensor-core product of adc_int8_mma_kernel.cu; "lookup", the lookup
    scan of adc_scan.cuh). Every count at 0, ``search(k=10, rerank=400,
    int8_lut=True)`` at batches 256 and 32: one int8-LUT launch each, each
    of the tensor-core product on that route and none on the other, one
    re-rank, no dense scan; recall@10 >= 0.99 against the float64 oracle on
    the card; the kernel identical to its plain version at the searches'
    inputs; CUDA-event times of the kernel beside the bf16 LUT's (the
    kernel again after it), the plain version and both bounds; search()
    p50 with the int8 and with the bf16 LUT. Returns the kernels-line
    figures of the route's kernel."""
    from metrovector_tpu_torch import DistanceMetric
    from metrovector_tpu_torch.ops.adc_kernel import (
        fused_adc_topk, fused_adc_topk_reference, int8_lut_route,
    )
    from metrovector_tpu_torch.ops.gather_kernel import rescore_candidates
    from metrovector_tpu_torch.ops.topk_kernel import fused_topk
    from metrovector_tpu_torch.utils.timing import cuda_ms

    l2 = DistanceMetric.L2
    m, ksub = idx.m, idx.ksub
    n, cols = idx.codes.shape
    packed = idx.packed4
    if int8_lut_route(ksub, m, cols) != route:
        raise AssertionError(f"{name} (m={m}, ksub={ksub}) does not route to {route}")
    for fn in (fused_adc_topk, rescore_candidates, fused_topk):
        fn.launches = 0
    fused_adc_topk.int8_launches = 0
    fused_adc_topk.int8_mma_launches = 0
    res = {bsz: idx.search(q, k=K_PQ, rerank=RERANK, int8_lut=True)
           for bsz, q in queries.items()}
    searches = len(res)
    got = (fused_adc_topk.launches, fused_adc_topk.int8_launches,
           fused_adc_topk.int8_mma_launches, rescore_candidates.launches,
           fused_topk.launches)
    if got != (searches, searches, searches if route == "mma" else 0, searches, 0):
        raise AssertionError(f"{name} int8 LUT: {searches} searches counted (K2, of it int8 "
                             f"LUT, of it tensor-core product, K3, K1) {got}")
    launches = got[2] if route == "mma" else got[1]
    recall = {bsz: _recall_on_card(torch, x64, norms64, q, res[bsz].indices, K_PQ)
              for bsz, q in queries.items()}
    if min(recall.values()) < 0.99:
        raise AssertionError(f"{name} int8 LUT recall@10 {recall}")
    say(f"  {name} search(k=10, rerank=400, int8_lut=True): recall@10 "
        + ", ".join(f"batch {b} {r:.4f}" for b, r in recall.items())
        + f" against the float64 oracle on the card; {route} launches {launches}")
    rng = np.random.default_rng(SEED + 14)
    kernel = "int8_mma" if route == "mma" else "int8_lut"
    cell = {}
    for bsz, q in queries.items():
        qs = [torch.from_numpy(q).to(dev)]
        qs += [torch.from_numpy(np.clip(q + rng.integers(-3, 4, q.shape), 0, 255)
                                .astype(np.float32)).to(dev) for _ in range(9)]
        args = (idx.codes, idx._books, idx.recon_norms, idx.num_vectors, RERANK, l2,
                idx.valid, False, packed)

        def kern(qd):
            return fused_adc_topk(qd, *args, int8_lut=True)

        def plain(qd):
            return fused_adc_topk_reference(qd, *args, int8_lut=True)

        def bf16(qd):
            return fused_adc_topk(qd, *args)

        _identical(torch, kern(qs[0]), plain(qs[0]), f"{name} int8 LUT batch {bsz}")
        kms, runs, pms = _kernel_times(torch, dev, kern, plain, qs, qs[:3])
        bf16(qs[0])
        bms = cuda_ms(bf16, qs, dev)
        kms2 = cuda_ms(kern, qs, dev)
        hq = [t.cpu().numpy() for t in qs]
        p50 = _p50(torch, idx.search, hq, dev, k=K_PQ, rerank=RERANK, int8_lut=True)
        p50_bf = _p50(torch, idx.search, hq, dev, k=K_PQ, rerank=RERANK, exact_lut=False)
        bnd = lut8_bounds(bsz, n, m, ksub, cols, RERANK)
        cell[bsz] = {"ms": kms, "plain_ms": pms, "bound": bnd["least"], "bounds": bnd,
                     "p50": p50, "bf16_ms": bms, "p50_bf16": p50_bf}
        cc, tc = bnd["cuda_cores"], bnd["tensor_cores"]
        say(f"  {name} batch={bsz}: fused_adc_topk[{kernel}] k={RERANK} {kms:.4f} ms "
            f"(runs {runs[0]:.4f}, {runs[1]:.4f}, after the bf16 LUT {kms2:.4f}; bounds: "
            f"CUDA-core adds {cc[0]:.4f} ms by {cc[1]}, tensor-core product {tc[0]:.4f} "
            f"ms by {tc[1]}, share of the lesser {bnd['least'][0] / kms:.1%}) | plain "
            f"{pms:.4f} | bf16 LUT {bms:.4f} | search() p50 int8 LUT {p50:.4f} ms "
            f"({bsz / p50 * 1e3:.0f} QPS), bf16 LUT {p50_bf:.4f} | {card}")
    return {"launches": launches, "cell": cell, "recall": recall}


def phase_pq_path(torch, dev, card, keep=None):
    """The PQ path end to end at full size (module docstring, phase 8)."""
    from metrovector_tpu_torch import Builder, DistanceMetric, Reader
    from metrovector_tpu_torch.index.pq import (
        PQIndex, encode_pq, pack_codes4, train_pq, unpack_codes4,
    )
    from metrovector_tpu_torch.ops.adc_kernel import (
        adc_lut, fused_adc_topk, fused_adc_topk_reference,
    )
    from metrovector_tpu_torch.ops.gather_kernel import (
        gather_rows, gather_rows_reference, rescore_candidates,
        rescore_candidates_reference,
    )
    from metrovector_tpu_torch.ops.topk_kernel import fused_topk
    from metrovector_tpu_torch.utils.timing import cuda_ms, device_ms, sync_time

    L2 = DistanceMetric.L2
    rng = np.random.default_rng(SEED)
    t0 = time.perf_counter()
    x = _clustered_u8_corpus(rng, N_MAIN, D_MAIN)
    x64 = torch.from_numpy(x).to(dev, torch.float64)
    norms64 = (x64 * x64).sum(1)
    say(f"  corpus {N_MAIN}x{D_MAIN} clustered u8-valued f32 (seed {SEED}) "
        f"made in {time.perf_counter() - t0:.1f} s")
    queries = {bsz: _pq_queries(rng, x, bsz) for bsz in (256, 32)}
    wrappers = (fused_adc_topk, rescore_candidates, gather_rows)
    counts = {fn.__name__: 0 for fn in wrappers}
    times, recalls = {}, {}
    kept = None  # the pq4 index and its oracle data, for phase 9
    kept8 = None  # the sift1m-pq index, for phase 16
    tmp = tempfile.TemporaryDirectory()
    try:
        for name, m, ksub, packed in PQ_CONFIGS:
            t0 = time.perf_counter()
            books = train_pq(x, m=m, ksub=ksub, seed=SEED, device=dev)
            codes = encode_pq(x, books, device=dev)
            t_train = time.perf_counter() - t0
            stored = pack_codes4(codes) if packed else codes
            path = os.path.join(keep or tmp.name, f"{name}.mvt")
            t0 = time.perf_counter()
            b = Builder()
            b.add_vector_space("sift", dim=D_MAIN, metric=L2)
            b.add_vectors("sift", x)
            b.set_pq_index("sift", books, stored, packed4=packed)
            b.build().save(path)
            t_save = time.perf_counter() - t0
            if packed:
                _keep_for_p17(name, path)
            t0 = time.perf_counter()
            idx = PQIndex.from_space(Reader.open(path).vector_space("sift"),
                                     device="cuda")
            torch.cuda.synchronize()
            t_open = time.perf_counter() - t0
            if not (idx.packed4 == packed
                    and np.array_equal(idx.codes.cpu().numpy(), stored)
                    and np.array_equal(idx.codebooks, books)):
                raise AssertionError(f"{name}: from_space did not reuse the sidecar")
            say(f"  {name}: train_pq + encode_pq on the card {t_train:.1f} s; "
                f"file written {t_save:.1f} s; Reader.open + PQIndex.from_space "
                f"{t_open:.2f} s; {idx.code_bytes_per_vector} B/row codes")

            # The main path: every count at 0, the searches, counts read.
            # search() itself runs K2 and the fused rescore; gather_rows has
            # no caller in the package, so its launches here are this
            # script's own fetch of the answers' rows from the card.
            for fn in wrappers + (fused_topk,):
                fn.launches = 0
            results = {}
            for bsz, q in queries.items():
                before = (fused_adc_topk.launches, rescore_candidates.launches)
                res = idx.search(q, k=K_PQ, rerank=RERANK)
                if (fused_adc_topk.launches, rescore_candidates.launches) != (
                        before[0] + 1, before[1] + 1):
                    raise AssertionError(f"{name}: search() did not launch "
                                         "K2 and K3 once each")
                rows = gather_rows(idx.db, torch.from_numpy(
                    res.indices.reshape(-1)).to(dev))
                if not np.array_equal(rows.cpu().numpy(),
                                      x[res.indices.reshape(-1)]):
                    raise AssertionError(f"{name}: gathered rows differ")
                results[bsz] = res
            for fn in wrappers:
                counts[fn.__name__] += fn.launches
            if fused_topk.launches:
                raise AssertionError(f"{name}: the PQ path ran the exact kernel")

            codes_u8 = unpack_codes4(stored, m) if packed else stored
            for bsz, q in queries.items():
                rec = _recall_on_card(torch, x64, norms64, q,
                                      results[bsz].indices, K_PQ)
                recalls[(name, bsz)] = rec
                if rec < 0.99:
                    raise AssertionError(f"{name}: recall@10 {rec} < 0.99 at batch {bsz}")
                qd = torch.from_numpy(q).to(dev)
                adc_args = (qd, idx.codes, idx._books, idx.recon_norms,
                            idx.num_vectors, RERANK, L2, idx.valid, True, packed)
                got = fused_adc_topk(*adc_args)
                ref = fused_adc_topk_reference(*adc_args)
                same = _same_candidates(
                    torch, got, ref, adc_lut(qd, idx._books, True), codes_u8,
                    idx.recon_norms.cpu().numpy(), m, ksub, f"{name} batch={bsz}")
                s_r, i_r = rescore_candidates_reference(
                    qd, idx.db, idx.db_norms, got[1], K_PQ, L2, "position")
                if not (np.array_equal(results[bsz].indices, i_r.cpu().numpy())
                        and np.array_equal(results[bsz].scores, s_r.cpu().numpy())):
                    raise AssertionError(f"{name}: search() differs from the "
                                         "plain re-rank of its candidates")
                say(f"  {name} batch={bsz}: recall@10 = {rec:.4f} against the "
                    f"float64 oracle on the card; K2 vs plain at full size "
                    f"{'identical' if same else 'within the band'}; re-rank "
                    f"identical to the plain version")

            for bsz in queries:
                iters = 20
                qs = [torch.from_numpy(_pq_queries(rng, x, bsz)).to(dev)
                      for _ in range(iters)]

                def k2(q):
                    return fused_adc_topk(q, idx.codes, idx._books, idx.recon_norms,
                                          idx.num_vectors, RERANK, L2, None, True, packed)

                def k2_plain(q):
                    return fused_adc_topk_reference(
                        q, idx.codes, idx._books, idx.recon_norms,
                        idx.num_vectors, RERANK, L2, None, True, packed)

                cands = [k2(q)[1] for q in qs]
                pairs = list(zip(qs, cands))
                flat = [c.reshape(-1).clamp(min=0) for c in cands]  # rows to fetch

                def k3(p):
                    return rescore_candidates(p[0], idx.db, idx.db_norms, p[1],
                                              K_PQ, L2)

                def k3_plain(p):
                    return rescore_candidates_reference(p[0], idx.db, idx.db_norms,
                                                        p[1], K_PQ, L2)

                def gat(r):
                    return gather_rows(idx.db, r)

                def gat_plain(r):
                    return gather_rows_reference(idx.db, r)

                def gat_library(r):
                    return torch.index_select(idx.db, 0, r)

                def k1(q):
                    return fused_topk(q, idx.db, idx.db_norms, idx.num_vectors,
                                      K_PQ, L2)

                # K2 is longer than its launch: events around the calls.
                # K3 and the gather are shorter: device_ms times the device
                # alone (the host has queued every call before the first
                # event), and the per-call time is kept beside it.
                row = {}
                for key, kern, plain, inputs, timer in (
                        ("k2", k2, k2_plain, qs, cuda_ms),
                        ("k3", k3, k3_plain, pairs, device_ms),
                        ("gather", gat, gat_plain, flat, device_ms)):
                    kern(inputs[0])
                    plain(inputs[0])
                    few = inputs[:5]
                    p1 = timer(plain, few, dev)
                    a1 = timer(kern, inputs, dev)
                    a2 = timer(kern, inputs, dev)
                    p2 = timer(plain, few, dev)
                    row[key] = ((a1 + a2) / 2, (p1 + p2) / 2)
                    if timer is device_ms:
                        row[key + "_call"] = cuda_ms(kern, inputs, dev)
                gat_library(flat[0])  # index_select on the same int32 indices
                row["gather_library"] = device_ms(gat_library, flat, dev)
                k1(qs[0])
                row["k1"] = cuda_ms(k1, qs, dev)
                host = [q.cpu().numpy() for q in qs]
                idx.search(host[0], k=K_PQ, rerank=RERANK)
                row["e2e"] = float(np.median([
                    sync_time(idx.search, q, k=K_PQ, rerank=RERANK, device=dev)[0]
                    for q in host])) * 1e3
                times[(name, bsz)] = row
                row["split"] = _pq_host_split(torch, dev, idx, packed, qs, host)
                say(f"  timing {name} batch={bsz}: K2 {row['k2'][0]:.4f} ms "
                    f"(plain {row['k2'][1]:.4f}) | K3 rescore device {row['k3'][0]:.4f} ms, "
                    f"per call {row['k3_call']:.4f} (plain {row['k3'][1]:.4f}) | gather "
                    f"{bsz * RERANK} rows device {row['gather'][0]:.4f} ms, per call "
                    f"{row['gather_call']:.4f} (plain {row['gather'][1]:.4f}, "
                    f"index_select on the same int32 indices {row['gather_library']:.4f}) | "
                    f"search() p50 {row['e2e']:.4f} ms = "
                    f"{bsz / row['e2e'] * 1e3:.0f} QPS | K1 exact search "
                    f"{row['k1']:.4f} ms | {card}")
                sp = row["split"]
                say(f"  search() step by step, {name} batch={bsz} (host ms, synchronized "
                    f"after each): prep + upload {sp['prep']:.4f} | K2 {sp['k2']:.4f} "
                    f"(device {sp['k2_device']:.4f}, of it adc_lut {sp['lut_device']:.4f}; "
                    f"wrapper {sp['k2_host_us']:.1f} us) | K3 {sp['k3']:.4f} (device "
                    f"{sp['k3_device']:.4f}; wrapper {sp['k3_host_us']:.1f} us) | two "
                    f"readbacks {sp['readback']:.4f} | finalize {sp['finalize']:.4f} | "
                    f"sum {sum(sp[k] for k in ('prep', 'k2', 'k3', 'readback', 'finalize')):.4f}"
                    f" vs p50 {row['e2e']:.4f} | {card}")
            if packed:
                kept = (idx, x64, norms64, queries)
            else:
                times["int8_lookup"] = _int8_lut_searches(
                    torch, dev, card, "sift1m-pq", "lookup", idx, x64, norms64, queries)
                kept8 = idx  # for phase 16
                del idx
            torch.cuda.empty_cache()
    finally:
        tmp.cleanup()

    # A full re-rank takes the reference's route (the ADC fetch of every
    # row, then the re-rank with ties by candidate position): the same as
    # the plain versions of K2 and K3, and exact search up to exact ties.
    rng20 = np.random.default_rng(SEED + 8)
    x20 = _clustered_u8_corpus(rng20, 20_000, D_MAIN)
    books20 = train_pq(x20, m=32, ksub=16, seed=SEED, device=dev)
    idx20 = PQIndex.build(x20, L2, codebooks=books20, pack4=True, device="cuda")
    q20 = _pq_queries(rng20, x20, 32)
    for fn in (fused_adc_topk, rescore_candidates, fused_topk):
        fn.launches = 0
    res = idx20.search(q20, k=K_PQ, rerank=idx20.num_vectors)
    if (fused_adc_topk.launches, rescore_candidates.launches,
            fused_topk.launches) != (1, 1, 0):
        raise AssertionError("the 20k full re-rank did not run K2 then K3")
    qd = torch.from_numpy(q20).to(dev)
    _, cand = fused_adc_topk_reference(qd, idx20.codes, idx20._books,
                                       idx20.recon_norms, idx20.num_vectors,
                                       idx20.num_vectors, L2, None, True, True)
    s_r, i_r = rescore_candidates_reference(qd, idx20.db, idx20.db_norms, cand,
                                            K_PQ, L2, "position")
    if not (np.array_equal(res.indices, i_r.cpu().numpy())
            and np.array_equal(res.scores, s_r.cpu().numpy())):
        raise AssertionError("20k full re-rank differs from the plain route")
    x20_64 = torch.from_numpy(x20).to(dev, torch.float64)
    rec20 = _recall_on_card(torch, x20_64, (x20_64 * x20_64).sum(1), q20,
                            res.indices, K_PQ)
    if rec20 != 1.0:
        raise AssertionError(f"20k full re-rank recall@10 {rec20} != 1")
    say(f"phase 8 PQ path: ok (recall@10 "
        + ", ".join(f"{n} batch {b} {r:.4f}" for (n, b), r in recalls.items())
        + f"; launches {counts}; 20k full re-rank through K2 + K3 identical "
        "to the plain route, recall@10 1.0000)")
    return counts, times, kept, kept8


def _identical(torch, got, ref, what) -> None:
    if not (torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])):
        raise AssertionError(f"{what}: kernel differs from plain on integer data")


def _k_at_split_length(torch, dev, rng) -> tuple[str, int]:
    """k equal to the rows of a split, so that a split's list holds k rows
    only after its last one: fused_topk at batches 32 and 33 (one query
    tile and two) and fused_adc_topk at batches 1 and 37 over 20,000 rows
    with twins, k
    taken from the split the wrapper chose (read through
    select.row_splits) until the two agree; each case run twice and
    identical to the plain version. Returns (what was hit, cases)."""
    from metrovector_tpu_torch import DistanceMetric
    from metrovector_tpu_torch.index.pq import pack_codes4
    from metrovector_tpu_torch.ops import select
    from metrovector_tpu_torch.ops.adc_kernel import (
        fused_adc_topk, fused_adc_topk_reference,
    )
    from metrovector_tpu_torch.ops.topk_kernel import (
        fused_topk, fused_topk_reference,
    )

    L2 = DistanceMetric.L2
    n = 20_000
    x = torch.from_numpy(_twin_rows(rng, n, D_MAIN, 256, 500)).to(dev)
    norms = (x.double() ** 2).sum(1).float()
    books = rng.integers(0, 8, (32, 16, 4)).astype(np.float32)
    codes = rng.integers(0, 16, (500, 32)).astype(np.uint8)[rng.integers(0, 500, n)]
    recon = np.concatenate([books[j][codes[:, j]] for j in range(32)], 1)
    rn = torch.from_numpy((recon.astype(np.float64) ** 2).sum(1).astype(np.float32)).to(dev)
    codes_d = torch.from_numpy(pack_codes4(codes)).to(dev)
    books_d = torch.from_numpy(books).to(dev)
    runs = [("fused_topk", nq, fused_topk, fused_topk_reference,
             lambda q, k: (q, x, norms, n, k, L2),
             rng.integers(0, 256, (nq, D_MAIN))) for nq in (32, 33)]
    runs += [("fused_adc_topk", nq, fused_adc_topk, fused_adc_topk_reference,
              lambda q, k: (q, codes_d, books_d, rn, n, k, L2, None, True, True),
              rng.integers(0, 8, (nq, 128))) for nq in (1, 37)]
    seen = []
    real = select.row_splits

    def spy(*a, **kw):
        seen.append(real(*a, **kw))
        return seen[-1]

    hit, cases = [], 0
    select.row_splits = spy
    try:
        for name, nq, fn, plain, make, q_host in runs:
            q = torch.from_numpy(q_host.astype(np.float32)).to(dev)
            k = 10
            for _ in range(6):  # the split depends on k through occupancy
                seen.clear()
                fn(*make(q, k))
                rows = seen[-1][1]
                if rows == k or rows > n:
                    break
                k = rows
            args = make(q, k)
            _twice_identical(torch, fn, args, plain(*args),
                             f"{name} Q={nq} k={k} (rows per split {rows})")
            cases += 1
            if rows == k:
                hit.append(f"{name} Q={nq} k={k}")
    finally:
        select.row_splits = real
    if not hit:
        raise AssertionError("no case reached k = rows per split")
    return ", ".join(hit), cases


def phase_any_k(torch, dev, card, engine, pq4):
    """Phase 9 (module docstring). Integer data keeps every sum exact in
    f32 (values in [0, 15] at D = 1536 and 3072), so each kernel must be
    identical to its plain version."""
    from metrovector_tpu_torch import DistanceMetric
    from metrovector_tpu_torch.index.pq import pack_codes4
    from metrovector_tpu_torch.ops.adc_kernel import (
        fused_adc_topk, fused_adc_topk_reference,
    )
    from metrovector_tpu_torch.ops.gather_kernel import (
        rescore_candidates, rescore_candidates_reference,
    )
    from metrovector_tpu_torch.ops.topk_kernel import (
        fused_topk, fused_topk_reference,
    )
    from metrovector_tpu_torch.utils.timing import cuda_ms, sync_time

    L2, IP = DistanceMetric.L2, DistanceMetric.INNER_PRODUCT
    rng = np.random.default_rng(SEED + 9)
    n, nq, cases = 20_000, 37, 0
    for d, hi, ks in ((128, 256, (257, 1000, 1025, 5000, n)),
                      (1536, 16, (10, 300)), (3072, 16, (10, 300))):
        x = torch.from_numpy(rng.integers(0, hi, (n, d)).astype(np.float32)).to(dev)
        norms = (x.double() ** 2).sum(1).float()
        q = torch.from_numpy(rng.integers(0, hi, (nq, d)).astype(np.float32)).to(dev)
        mask = torch.from_numpy((rng.random(n) > 0.1).astype(np.float32)).to(dev)
        for k in ks:
            for metric in (L2, IP):
                args = (q, x, norms, n - 11, k, metric, mask if k % 2 else None)
                _identical(torch, fused_topk(*args), fused_topk_reference(*args),
                           f"fused_topk D={d} k={k} {metric.name}")
                cases += 1
    for packed, m, ksub in ((False, 16, 256), (True, 32, 16)):
        books = rng.integers(0, 8, (m, ksub, 4)).astype(np.float32)
        codes = rng.integers(0, ksub, (n, m)).astype(np.uint8)
        recon = np.concatenate([books[j][codes[:, j]] for j in range(m)], 1)
        rn = torch.from_numpy((recon.astype(np.float64) ** 2).sum(1).astype(np.float32)).to(dev)
        codes_d = torch.from_numpy(pack_codes4(codes) if packed else codes).to(dev)
        books_d = torch.from_numpy(books).to(dev)
        q = torch.from_numpy(rng.integers(0, 8, (nq, m * 4)).astype(np.float32)).to(dev)
        for k in (1025, 4096, n):
            args = (q, codes_d, books_d, rn, n, k, L2, None, True, packed)
            _identical(torch, fused_adc_topk(*args), fused_adc_topk_reference(*args),
                       f"fused_adc_topk packed4={packed} k={k}")
            cases += 1
    base = rng.integers(0, 256, (n // 8, D_MAIN)).astype(np.float32)
    x = torch.from_numpy(base[rng.integers(0, n // 8, n)]).to(dev)  # twins
    norms = (x.double() ** 2).sum(1).float()
    q = torch.from_numpy(rng.integers(0, 256, (nq, D_MAIN)).astype(np.float32)).to(dev)
    for r, k in ((4097, 100), (8192, 10), (8192, 8192)):
        cand = rng.integers(0, n, (nq, r)).astype(np.int32)
        cand[:, ::9] = -1
        cand = torch.from_numpy(cand).to(dev)
        for tie in ("position", "row"):
            args = (q, x, norms, cand, k, L2, tie)
            _identical(torch, rescore_candidates(*args),
                       rescore_candidates_reference(*args),
                       f"rescore_candidates R={r} k={k} tie={tie}")
            cases += 1
    at_split, split_cases = _k_at_split_length(torch, dev, rng)
    cases += split_cases
    torch.cuda.synchronize()

    # At full size: a re-rank of 2000 candidates (K2 keeps its lists in
    # device memory above k = 1024).
    idx, x64, norms64, queries = pq4
    q32 = queries[32]
    for fn in (fused_adc_topk, rescore_candidates, fused_topk):
        fn.launches = 0
    res = idx.search(q32, k=K_PQ, rerank=2000)
    if (fused_adc_topk.launches, rescore_candidates.launches,
            fused_topk.launches) != (1, 1, 0):
        raise AssertionError("search(rerank=2000) did not run K2 then K3")
    rec = _recall_on_card(torch, x64, norms64, q32, res.indices, K_PQ)
    if rec < 0.99:
        raise AssertionError(f"sift1m-pq4 rerank=2000 recall@10 {rec} < 0.99")
    pq_ms = float(np.median([sync_time(idx.search, q32, k=K_PQ, rerank=2000,
                                       device=dev)[0] for _ in range(10)])) * 1e3

    # SearchEngine.search(k=1000) on the 1M x 128 corpus of phase 3.
    sp = engine.space
    qh = rng.integers(0, 256, (32, D_MAIN)).astype(np.float32)
    fused_topk.launches = 0
    res = engine.search(qh, k=1000)
    if fused_topk.launches != 1:
        raise AssertionError("search(k=1000) did not launch fused_topk once")
    qd = torch.from_numpy(qh).to(dev)
    s_r, i_r = fused_topk_reference(qd, sp.data, sp.norms, sp.num_valid, 1000,
                                    L2, sp.valid_mask)
    if not (np.array_equal(res.indices, i_r.cpu().numpy())
            and np.array_equal(res.scores, s_r.cpu().numpy())):
        raise AssertionError("search(k=1000) differs from the plain version")
    inputs = [torch.from_numpy(rng.integers(0, 256, (32, D_MAIN)).astype(
        np.float32)).to(dev) for _ in range(10)]

    def k1000(q):
        return fused_topk(q, sp.data, sp.norms, sp.num_valid, 1000, L2,
                          sp.valid_mask)

    def k1000_plain(q):
        return fused_topk_reference(q, sp.data, sp.norms, sp.num_valid, 1000,
                                    L2, sp.valid_mask)

    k1000(inputs[0])
    k1000_plain(inputs[0])
    kms = cuda_ms(k1000, inputs, dev)
    pms = cuda_ms(k1000_plain, inputs[:3], dev)
    say(f"  sift1m-pq4 batch=32 search(k=10, rerank=2000): recall@10 = {rec:.4f}, "
        f"K2 then K3 once each, p50 {pq_ms:.4f} ms | {card}")
    say(f"  SearchEngine.search(k=1000) batch=32 on 1M x 128: identical to the "
        f"plain version; fused_topk {kms:.4f} ms (plain {pms:.4f}) | {card}")
    say(f"phase 9 any k and D: ok ({cases} cases identical to the plain versions; "
        f"k = rows per split: {at_split})")
    return {"pq_rerank2000_ms": pq_ms, "k1000_ms": kms, "k1000_plain_ms": pms,
            "recall": rec}


def _sparse_corpus(rng, kind, n, dim):
    """A CSR corpus of up to 40 entries a row (columns may repeat), every
    tenth of the first 100 rows empty, 20 rows of 100-300 entries (past the
    ELL width: they spill into the overflow)."""
    counts = rng.integers(1, 41, n)
    counts[:100:10] = 0
    counts[rng.choice(np.arange(100, n), 20, replace=False)] = rng.integers(100, 301, 20)
    indptr = np.zeros(n + 1, np.int64)
    np.cumsum(counts, out=indptr[1:])
    cols = rng.integers(0, dim, int(indptr[-1])).astype(np.int32)
    vals = (rng.integers(-4, 5, cols.size) if kind == "integer"
            else rng.standard_normal(cols.size)).astype(np.float32)
    return indptr, cols, vals


def _sparse_queries(rng, kind, nq, dim):
    """Queries of 64 nonzeros each: query 0 all zero, column 5 held by every
    other query, and -0.0 written over some zeros."""
    q = np.zeros((nq, dim), np.float32)
    at = rng.integers(0, dim, (nq, 64))
    q[np.arange(nq)[:, None], at] = (rng.integers(-3, 4, (nq, 64)) if kind == "integer"
                                     else rng.standard_normal((nq, 64)))
    q[:, 5] = 2.0 if kind == "integer" else 0.5
    q[0] = 0.0
    neg = rng.random(q.shape) < 0.01
    q[neg & (q == 0)] = -0.0
    return q


def _same_postings(torch, got, ref, what) -> float:
    """Hold query_postings' result against its plain version's: qptr equal,
    and the first qptr[-1] entries equal (NaN for NaN). Returns the largest
    difference in qptr, post_q and the finite post_v."""
    if not torch.equal(got[0], ref[0]):
        raise AssertionError(f"query_postings {what}: qptr differs from plain")
    total = int(ref[0][-1])
    if not torch.equal(got[1][:total], ref[1]):
        raise AssertionError(f"query_postings {what}: post_q differs from plain")
    torch.testing.assert_close(got[2][:total], ref[2], rtol=0, atol=0,
                               equal_nan=True)
    fin = torch.isfinite(ref[2])
    err = 0.0
    for a, b in ((got[0], ref[0]), (got[1][:total], ref[1]),
                 (got[2][:total][fin], ref[2][fin])):
        if a.numel():
            err = max(err, float((a.double() - b.double()).abs().max()))
    return err


def _postings_vs_plain(torch, dev, rng) -> tuple[int, float]:
    """query_postings against its plain version (signed zeros, inf, NaN,
    several query tiles). Returns the cases run and the largest difference."""
    from metrovector_tpu_torch.ops.sparse_kernel import (
        _tile_shape, query_postings, query_postings_reference,
    )

    cases, err = 0, 0.0
    for nq in (1, 37, 256, 300):
        q = rng.integers(-2, 3, (4096, nq)).astype(np.float32)
        q[rng.random(q.shape) < 0.9] = 0
        q[0, :] = -0.0
        q[1, 0], q[2, -1], q[3, nq // 2] = np.inf, -np.inf, np.nan
        qt = torch.from_numpy(q).to(dev)
        for qtile in sorted({32, 32 * _tile_shape(nq)[0]}):
            err = max(err, _same_postings(torch, query_postings(qt, qtile),
                                          query_postings_reference(qt, qtile),
                                          f"Q={nq} tile {qtile}"))
            cases += 1
    return cases, err


def phase_sparse_vs_plain(torch, dev) -> tuple[float, float]:
    """Phase 10 (module docstring). Both versions add a row's products in
    slot order, then its overflow entries, each product and sum rounded to
    f32 on its own, so on integer data they must be identical. On float data
    the band is two f32 sums of the row's R terms, 2 R 2^-24 sum_r |q v|
    (doubled for L2, scaled by 1/|x| for cosine)."""
    from metrovector_tpu_torch import DistanceMetric
    from metrovector_tpu_torch.ops.sparse_kernel import (
        _query_chunks, ell_dots, ell_dots_reference, ell_topk, ell_topk_reference,
    )
    from metrovector_tpu_torch.sparse import ell_layout

    rng = np.random.default_rng(SEED + 10)
    postings, post_err = _postings_vs_plain(torch, dev, rng)
    n, dim = 20_000, 4096
    metrics = (DistanceMetric.L2, DistanceMetric.INNER_PRODUCT,
               DistanceMetric.COSINE)
    max_err, dots_err, cases, identical = 0.0, 0.0, 0, 0
    for kind in ("integer", "normal"):
        indptr, cols, vals = _sparse_corpus(rng, kind, n, dim)
        lay = ell_layout(indptr, cols, vals, n)
        n_pad = lay["cols_ell"].shape[0]
        t = {key: torch.from_numpy(v).to(dev) for key, v in lay.items()}
        if int(lay["ovf_ptr"][-1]) == 0:
            raise AssertionError("no row spilled into the overflow")
        rows = np.repeat(np.arange(n), np.diff(indptr))
        x64 = torch.zeros((n, dim), dtype=torch.float64, device=dev)
        x64.index_put_((torch.from_numpy(rows).to(dev), torch.from_numpy(cols).long().to(dev)),
                       torch.from_numpy(vals).double().to(dev), accumulate=True)
        norms = torch.zeros(n_pad, device=dev)
        norms[:n] = (x64 ** 2).sum(1).float()
        cnt = torch.from_numpy(np.diff(indptr)).to(dev).double()
        absx = torch.zeros_like(x64)
        absx.index_put_((torch.from_numpy(rows).to(dev), torch.from_numpy(cols).long().to(dev)),
                        torch.from_numpy(np.abs(vals)).double().to(dev), accumulate=True)
        tomb = torch.from_numpy((rng.random(n_pad) > 0.1).astype(np.float32)).to(dev)
        filt = torch.from_numpy((rng.random(n_pad) > 0.5).astype(np.float32)).to(dev)
        few = torch.zeros(n_pad, device=dev)
        few[torch.from_numpy(rng.choice(n, 1500, replace=False)).to(dev)] = 1.0
        batches = [("dense", nq, (rng.integers(-3, 4, (nq, dim)) if kind == "integer"
                                  else rng.standard_normal((nq, dim))).astype(np.float32))
                   for nq in (1, 37, 256)]
        batches += [("sparse", nq, _sparse_queries(rng, kind, nq, dim)) for nq in (37, 256)]
        for shape, nq, q_all in batches:
            qt = torch.from_numpy(np.ascontiguousarray(q_all.T)).to(dev)
            got, ref = ell_dots(qt, t["cols_ell"], t["vals_ell"]), \
                ell_dots_reference(qt, t["cols_ell"], t["vals_ell"])
            if kind == "integer" and not torch.equal(got, ref):
                raise AssertionError(f"ell_dots {shape} Q={nq} differs from plain on integer data")
            err = float((got - ref).abs().max())
            if kind == "normal" and err > 1e-3:
                raise AssertionError(f"ell_dots {shape} Q={nq}: |diff| {err}")
            identical += bool(torch.equal(got, ref))
            dots_err = max(dots_err, err)
            cases += 1
            for metric in metrics:
                q = q_all
                if metric == DistanceMetric.COSINE:
                    q = (q / np.maximum(np.linalg.norm(q, axis=1, keepdims=True),
                                        1e-30)).astype(np.float32)
                qt = torch.from_numpy(np.ascontiguousarray(q.T)).to(dev)
                q64 = qt.double().T
                dots64 = q64 @ x64.T
                band = (2 * cnt[None] * 2.0**-24 * (q64.abs() @ absx.T))
                if metric == DistanceMetric.L2:
                    s64 = 2 * dots64 - norms[:n].double()[None]
                    band = 2 * band
                elif metric == DistanceMetric.COSINE:
                    inv = 1 / norms[:n].double().clamp(min=1e-30).sqrt()
                    s64, band = dots64 * inv[None], band * inv[None] + 2.0**-21
                else:
                    s64 = dots64
                tol = (band.max(1).values + 4 * 2.0**-24 * s64.abs().max(1).values).cpu().numpy()
                runs = []
                for k in (1, 10, 100, 2000):
                    variant = (cases + len(runs)) % 4
                    vm = (None, tomb, tomb * filt, tomb)[variant]
                    runs.append((k, n - 77 if variant == 3 else n, vm))
                runs.append((2000, n, few))  # k above the 1500 live rows
                for k, num_rows, vm in runs:
                    args = (qt, t["cols_ell"], t["vals_ell"], t["ovf_ptr"],
                            t["ovf_cols"], t["ovf_vals"], norms, num_rows, k,
                            metric, vm)
                    got = ell_topk(*args)
                    ref = ell_topk_reference(*args)
                    live = torch.arange(n, device=dev) < num_rows
                    if vm is not None:
                        live &= vm[:n] != 0
                    scores = torch.where(live[None], s64, float("-inf")).cpu().numpy()
                    n_live = int(live.sum())
                    if (got[1][:, min(k, n_live):] != -1).any():
                        raise AssertionError("ell_topk: slots beyond the live rows are not -1")
                    exact = kind == "integer" and metric != DistanceMetric.COSINE
                    what = (f"ell_topk {kind} {shape} {metric.name} Q={nq} k={k} "
                            f"num_rows={num_rows} mask={vm is not None}")
                    max_err = max(max_err, _compare(got, ref, exact, tol, scores, what))
                    identical += bool(torch.equal(got[0], ref[0])
                                      and torch.equal(got[1], ref[1]))
                    cases += 1
        del x64, absx
        if kind == "integer":  # a +inf corpus value: 0 * inf is NaN, as in plain
            vals_inf = t["vals_ell"].clone()
            vals_inf[200, 0] = float("inf")
            q = _sparse_queries(rng, kind, 37, dim)
            c_inf = int(lay["cols_ell"][200, 0])
            q[::2, c_inf], q[1::2, c_inf] = 1.0, 0.0  # zero in the odd queries
            qt = torch.from_numpy(np.ascontiguousarray(q.T)).to(dev)
            got = ell_dots(qt, t["cols_ell"], vals_inf)
            ref = ell_dots_reference(qt, t["cols_ell"], vals_inf)
            torch.testing.assert_close(got, ref, rtol=0, atol=0, equal_nan=True)
            if not (torch.isnan(got[200, 1::2]).all() and torch.isinf(got[200, ::2]).all()):
                raise AssertionError("ell_dots: the +inf entry's row is not inf/NaN")
            identical += 1
            cases += 1
            # A batch past one launch's postings: both wrappers run it as
            # two chunks of queries, one launch each.
            nq = _query_chunks(dim, 1 << 20)[0][1] + 232
            qt = torch.from_numpy(np.ascontiguousarray(
                _sparse_queries(rng, kind, nq, dim).T)).to(dev)
            before = (ell_dots.launches, ell_topk.launches)
            got = ell_dots(qt, t["cols_ell"], t["vals_ell"])
            if not torch.equal(got, ell_dots_reference(qt, t["cols_ell"], t["vals_ell"])):
                raise AssertionError(f"ell_dots Q={nq} (two chunks) differs from plain")
            del got
            args = (qt, t["cols_ell"], t["vals_ell"], t["ovf_ptr"], t["ovf_cols"],
                    t["ovf_vals"], norms, n, 10, DistanceMetric.INNER_PRODUCT, tomb)
            _identical(torch, ell_topk(*args), ell_topk_reference(*args),
                       f"ell_topk Q={nq} (two chunks)")
            if (ell_dots.launches - before[0], ell_topk.launches - before[1]) != (2, 2):
                raise AssertionError(f"Q={nq} did not run as two launches of each kernel")
            del qt
            torch.cuda.empty_cache()
            identical += 2
            cases += 2
    torch.cuda.synchronize()
    say(f"phase 10 sparse kernels vs plain: ok ({postings} postings cases "
        f"identical, max |diff| {post_err:.3g}; {cases} scan cases, "
        f"{identical} bit-identical, max |score diff| {max_err:.3g}, ell_dots "
        f"max |diff| {dots_err:.3g})")
    return max_err, dots_err


SPARSE_N, SPARSE_DIM, SPARSE_NNZ, SPARSE_QNNZ = 1_000_000, 30_522, 48, 256


def _splade_corpus(rng):
    """benchmarks/suite.py::bench_sparse1m's corpus (seed 12): 48 entries
    a row over a 30,522-term vocabulary, |N(0, 1)| values."""
    nnz = SPARSE_N * SPARSE_NNZ
    cols = rng.integers(0, SPARSE_DIM, nnz).astype(np.int32)
    vals = np.abs(rng.standard_normal(nnz)).astype(np.float32)
    return cols, vals


def _splade_queries(rng, nq):
    """The suite's queries: 256 nonzeros each, |N(0, 1)| values."""
    q = np.zeros((nq, SPARSE_DIM), np.float32)
    qc = rng.integers(0, SPARSE_DIM, (nq, SPARSE_QNNZ))
    q[np.arange(nq)[:, None], qc] = np.abs(
        rng.standard_normal((nq, SPARSE_QNNZ))).astype(np.float32)
    return q


def _sparse_recall(torch, cols_d, vals_d, q, got, k):
    """recall@k against float64 scores on the card. A returned row is a hit
    when its exact score is within the f32 band (2 R 2^-24 of the score:
    values and queries are non-negative) of the k-th best."""
    hits = 0
    c2 = cols_d.view(SPARSE_N, SPARSE_NNZ).long()
    v2 = vals_d.view(SPARSE_N, SPARSE_NNZ).double()
    for q0 in range(0, q.shape[0], 4):
        qd = torch.from_numpy(q[q0:q0 + 4]).to(cols_d.device, torch.float64)
        s = torch.stack([(qq[c2] * v2).sum(1) for qq in qd])
        kth = torch.sort(s, dim=1, descending=True).values[:, k - 1:k]
        r = torch.from_numpy(got[q0:q0 + 4].astype(np.int64)).to(cols_d.device)
        mine = torch.gather(s, 1, r.clamp(min=0))
        tol = 2 * SPARSE_NNZ * 2.0**-24 * kth
        hits += int(((mine >= kth - tol) & (r >= 0)).sum())
    return hits / (q.shape[0] * k)


def phase_sparse_path(torch, dev, card):
    """Phase 11 (module docstring): returns the timings and launch counts
    for the kernels line."""
    from metrovector_tpu_torch import (
        Builder, DistanceMetric, Reader, SparseSearchEngine, VectorType,
    )
    from metrovector_tpu_torch.ops import sparse_kernel
    from metrovector_tpu_torch.ops.sparse_kernel import (
        _tile_shape, ell_dots, ell_dots_reference, ell_topk, ell_topk_reference,
        query_postings, query_postings_reference,
    )
    from metrovector_tpu_torch.ops.topk_kernel import fused_topk
    from metrovector_tpu_torch.utils.timing import cuda_ms, device_ms, sync_time

    IP = DistanceMetric.INNER_PRODUCT
    rng = np.random.default_rng(12)
    t0 = time.perf_counter()
    cols, vals = _splade_corpus(rng)
    tmp = tempfile.TemporaryDirectory()
    try:
        path = os.path.join(tmp.name, "sparse1m.mvt")
        b = Builder()
        b.add_vector_space("splade", dim=SPARSE_DIM, vector_type=VectorType.SPARSE,
                           metric=IP)
        b.add_sparse_vectors("splade", zip(cols.reshape(SPARSE_N, SPARSE_NNZ),
                                           vals.reshape(SPARSE_N, SPARSE_NNZ)))
        b.build().save(path)
        _keep_for_p17("sparse1m", path)
        t_build = time.perf_counter() - t0
        t0 = time.perf_counter()
        space = Reader.open(path).vector_space("splade")
        engine = SparseSearchEngine(space, device="cuda")
        torch.cuda.synchronize()
        t_open = time.perf_counter() - t0
    finally:
        tmp.cleanup()
    if engine.formulation != "ell" or engine.r_cap != SPARSE_NNZ:
        raise AssertionError(f"auto chose {engine.formulation} R={engine.r_cap}")
    say(f"  sparse1m {SPARSE_N} x {SPARSE_DIM}, {SPARSE_NNZ} entries a row: "
        f"built and saved in {t_build:.1f} s; Reader.open + SparseSearchEngine "
        f"{t_open:.1f} s (ELL R={engine.r_cap}, {engine.nbytes / 2**20:.0f} MiB "
        "on the card)")
    # The file's CSR order (columns sorted within a row), for the oracle.
    indptr, fcols, fvals = space.sparse_csr()
    cols_d = torch.from_numpy(np.array(fcols, np.int32)).to(dev)
    vals_d = torch.from_numpy(np.array(fvals, np.float32)).to(dev)
    queries = {bsz: _splade_queries(rng, bsz) for bsz in (256, 32)}

    # The main path: every count at 0, the searches, counts read. The plain
    # version is counted through a wrapper that only the CPU path would call;
    # ell_dots has no caller in the package, so its launches are this
    # script's check of each answer's scores through the ELL contraction.
    plain_calls = []
    real_plain = sparse_kernel.ell_topk_reference
    sparse_kernel.ell_topk_reference = lambda *a, **kw: (
        plain_calls.append(1), real_plain(*a, **kw))[1]
    for fn in (ell_topk, ell_dots, query_postings, fused_topk):
        fn.launches = 0
    results = {}
    try:
        for bsz, q in queries.items():
            before = ell_topk.launches
            res = engine.search(q, k=10)
            if ell_topk.launches != before + 1:
                raise AssertionError("search() did not launch ell_topk once")
            rows = torch.from_numpy(res.indices.reshape(-1).astype(np.int64)).to(dev)
            qt = torch.from_numpy(np.ascontiguousarray(q.T)).to(dev)
            dots = ell_dots(qt, engine._cols_ell[rows].contiguous(),
                            engine._vals_ell[rows].contiguous())
            diag = torch.arange(bsz, device=dev)
            own = dots.view(bsz, 10, bsz)[diag, :, diag]
            if not np.array_equal(own.cpu().numpy(), res.scores):
                raise AssertionError("search() scores differ from ell_dots of its rows")
            results[bsz] = res
    finally:
        sparse_kernel.ell_topk_reference = real_plain
    launches = {"ell_topk": ell_topk.launches, "ell_dots": ell_dots.launches,
                "query_postings": query_postings.launches}
    if plain_calls or fused_topk.launches:
        raise AssertionError("the sparse path ran a plain version or K1")
    if query_postings.launches != ell_topk.launches + ell_dots.launches:
        raise AssertionError("a sparse scan ran without building its postings")

    recalls = {}
    for bsz, res in results.items():
        recalls[bsz] = _sparse_recall(torch, cols_d, vals_d, queries[bsz],
                                      res.indices, 10)
        if recalls[bsz] != 1.0:
            raise AssertionError(f"sparse1m recall@10 {recalls[bsz]} at batch {bsz}")
    say("  sparse1m recall@10 against the float64 oracle on the card: "
        + ", ".join(f"batch {b} {r:.4f}" for b, r in recalls.items())
        + f"; launches {launches}")

    with warnings.catch_warnings():  # torch flags sparse CSR as beta
        warnings.simplefilter("ignore", UserWarning)
        csr = torch.sparse_csr_tensor(
            torch.from_numpy(np.asarray(indptr, np.int64)).to(dev),
            cols_d.long(), vals_d, size=(SPARSE_N, SPARSE_DIM),
            check_invariants=False)
    times = {}
    for bsz in (256, 32):
        host = [_splade_queries(rng, bsz) for _ in range(6)]  # [Q, dim], as callers pass them
        qts = [torch.from_numpy(np.ascontiguousarray(q.T)).to(dev) for q in host]
        e = engine

        def kern(qt):
            return ell_topk(qt, e._cols_ell, e._vals_ell, None, None, None,
                            e._norms, e.num_vectors, 10, IP, e._valid)

        def plain(qt):
            return ell_topk_reference(qt, e._cols_ell, e._vals_ell, None, None,
                                      None, e._norms, e.num_vectors, 10, IP,
                                      e._valid)

        def dots(qt):
            return ell_dots(qt, e._cols_ell, e._vals_ell)

        def dots_plain(qt):
            return ell_dots_reference(qt, e._cols_ell, e._vals_ell)

        def library(qt):
            return torch.sparse.mm(csr, qt)

        qtile = 32 * _tile_shape(bsz)[0]

        def post(qt):
            return query_postings(qt, qtile)

        def post_plain(qt):
            return query_postings_reference(qt, qtile)

        row = {}
        got, ref = kern(qts[0]), plain(qts[0])
        _identical(torch, got, ref, f"ell_topk at sparse1m batch {bsz}")
        got, ref = post(qts[0]), post_plain(qts[0])
        row["post_err"] = _same_postings(torch, got, ref, f"at sparse1m batch {bsz}")
        row["nnz"] = int(ref[0][-1])
        del got, ref
        d_k, d_l = dots(qts[0])[:SPARSE_N], library(qts[0])
        row["dots_err"] = float((d_k - d_l).abs().max())
        del d_k, d_l
        p1 = cuda_ms(plain, qts[:1], dev)
        k1 = cuda_ms(kern, qts, dev)
        k2 = cuda_ms(kern, qts, dev)
        p2 = cuda_ms(plain, qts[:1], dev)
        row["ell_topk"], row["plain"] = (k1 + k2) / 2, (p1 + p2) / 2
        row["ell_dots"] = cuda_ms(dots, qts, dev)
        row["dots_plain"] = cuda_ms(dots_plain, qts[:1], dev)
        row["library"] = cuda_ms(library, qts, dev)
        row["postings"] = device_ms(post, qts, dev)
        row["postings_plain"] = cuda_ms(post_plain, qts[:1], dev)
        # The work these inputs need: products with a nonzero query value
        # (rows past num_vectors never enter ell_topk; ell_dots scores all).
        per_term = (qts[0] != 0).sum(1)
        row["macs_topk"] = int(per_term[e._cols_ell[:e.num_vectors].long()].sum())
        row["macs_dots"] = int(per_term[e._cols_ell.long()].sum())
        del per_term
        row["e2e"] = float(np.median([sync_time(engine.search, q, k=10, device=dev)[0]
                                      for q in host + host])) * 1e3
        times[bsz] = row
        say(f"  timing sparse1m batch={bsz}: ell_topk {row['ell_topk']:.4f} ms "
            f"(runs {k1:.4f}, {k2:.4f}; plain {row['plain']:.4f}) | ell_dots "
            f"{row['ell_dots']:.4f} ms (plain {row['dots_plain']:.4f}) vs "
            f"torch.sparse.mm {row['library']:.4f} "
            f"(max |diff| {row['dots_err']:.3g}) | postings build "
            f"{row['postings']:.4f} ms (plain {row['postings_plain']:.4f}; "
            f"{row['nnz']} nonzeros, identical to plain) | search() p50 {row['e2e']:.4f} ms "
            f"= {bsz / row['e2e'] * 1e3:.0f} QPS | {card}")
        torch.cuda.empty_cache()

    # The worst case of the postings design: every query fully dense, so
    # every term holds every query of the batch.
    dense = [torch.from_numpy(np.ascontiguousarray(np.abs(
        rng.standard_normal((32, SPARSE_DIM))).astype(np.float32).T)).to(dev)
        for _ in range(3)]
    _identical(torch, kern(dense[0]), plain(dense[0]),
               "ell_topk at sparse1m batch 32, dense queries")
    dots(dense[0])
    times["dense32"] = {"ell_topk": cuda_ms(kern, dense, dev),
                        "ell_dots": cuda_ms(dots, dense, dev)}
    say(f"  timing sparse1m batch=32, every query dense (the worst case): "
        f"ell_topk {times['dense32']['ell_topk']:.4f} ms | ell_dots "
        f"{times['dense32']['ell_dots']:.4f} ms | {card}")
    del dense
    torch.cuda.empty_cache()

    coo = SparseSearchEngine(space, device="cuda", formulation="coo")
    for bsz in (256, 32):
        t_coo, res = sync_time(coo.search, queries[bsz], k=10, device=dev)
        rec = _sparse_recall(torch, cols_d, vals_d, queries[bsz], res.indices, 10)
        if rec != 1.0:
            raise AssertionError(f"COO recall@10 {rec} at batch {bsz}")
        times[bsz]["coo"] = t_coo * 1e3
        say(f"  COO formulation batch={bsz}: {t_coo * 1e3:.1f} ms, recall@10 "
            f"{rec:.4f} (same answers as ELL up to f32 near-ties) | {card}")
    del coo, engine, csr
    torch.cuda.empty_cache()
    say(f"phase 11 sparse path: ok (recall@10 1.0000 at batches 256 and 32, "
        f"one ell_topk launch per search)")
    return launches, times


IVFPQ_CONFIGS = (  # benchmarks/suite.py's sift1m-ivfpq (:690) and sift1m-ivfpq4 (:769)
    ("sift1m-ivfpq", 16, 256, False), ("sift1m-ivfpq4", 32, 16, True),
)
IVF_CLUSTERS, IVF_NPROBE, IVF_ITERS = 1024, 16, 4
IVF_RERANKS = (100, 400)
IVF_BATCHES = (8, 32, 256)
IVF_CROSSOVER_BATCHES = (1, 4, 8, 16, 32, 64, 128, 256)
IVF_KERNEL_BATCHES = (1, 8, 256)


def _group_bias_case(rng, nq, groups, kind):
    """A bucket bias [nq, groups]: 16 probed buckets a query, two of them
    tied, −1e30 on the rest; integer biases above 256 in magnitude (a bf16
    LUT rounds them) or floats."""
    bias = np.full((nq, groups), -1e30, np.float32)
    for r in range(nq):
        probed = rng.choice(groups, 16, replace=False)
        if kind == "integer":
            vals = rng.integers(-3000, 3000, 16).astype(np.float32)
        else:
            vals = (rng.standard_normal(16) * 1000).astype(np.float32)
        vals[1] = vals[0]  # split buckets share a centroid: a tie
        bias[r, probed] = vals
    return bias


def _group_cases(torch, dev, rng) -> int:
    """K2's bucket-bias variant (group_bias + group_ids) against its plain
    version on the card: 200,003 rows of codes with twins across splits,
    4-bit m=32 and 8-bit m=16 codes, f32 and bf16 LUTs, integer and float
    codebooks, 1,500 and 40,000 buckets (bucket ids with tombstoned rows at
    -1 and live rows at -1), 16 probed buckets a query with a tie, batches
    1, 33 and 256, k in {10, 400, 1100} (lists in shared and in device
    memory), the tombstones' mask or that mask times a filter, and
    num_valid inside a split, in turn:
    identical to the plain version on float data too (both add the bias
    after the m lookups), and run twice on integer data. Returns the cases
    run and the largest |score difference| seen (0 when all are
    identical)."""
    from metrovector_tpu_torch import DistanceMetric
    from metrovector_tpu_torch.index.pq import pack_codes4
    from metrovector_tpu_torch.ops.adc_kernel import (
        fused_adc_topk, fused_adc_topk_reference,
    )

    n, cases, max_err = SPLIT_N, 0, 0.0
    metrics = (DistanceMetric.L2, DistanceMetric.INNER_PRODUCT,
               DistanceMetric.COSINE)
    mask = np.ones(n, np.float32)
    mask[40_000:120_000:3] = 0
    masks = (torch.from_numpy(mask).to(dev),
             torch.from_numpy(mask * (rng.random(n) < 0.5)).to(dev))  # a filter too
    for kind in ("integer", "normal"):
        for packed, m, ksub in ((True, 32, 16), (False, 16, 256)):
            if kind == "integer":
                books = rng.integers(0, 8, (m, ksub, 4)).astype(np.float32)
                q_host = rng.integers(0, 8, (256, m * 4)).astype(np.float32)
            else:
                books = rng.standard_normal((m, ksub, 4)).astype(np.float32)
                q_host = rng.standard_normal((256, m * 4)).astype(np.float32)
            codes = rng.integers(0, ksub, (3000, m)).astype(np.uint8)[
                rng.integers(0, 3000, n)]
            recon = np.concatenate([books[j][codes[:, j]] for j in range(m)], 1)
            rn = torch.from_numpy((recon.astype(np.float64) ** 2).sum(1).astype(
                np.float32)).to(dev)
            codes_d = torch.from_numpy(pack_codes4(codes) if packed else codes).to(dev)
            books_d = torch.from_numpy(books).to(dev)
            for groups in (1500, 40_000):
                gids = rng.integers(0, groups, n).astype(np.int32)
                gids[mask == 0] = -1   # tombstoned rows
                gids[7:200_003:9973] = -1  # live rows in no bucket
                gids_d = torch.from_numpy(gids).to(dev)
                for exact_lut in (True, False):
                    for nq, k in ((1, 10), (33, 400), (256, 400), (33, 1100)):
                        metric = metrics[cases % 3]
                        q = q_host[:nq]
                        if metric == DistanceMetric.COSINE:
                            q = q / np.maximum(np.linalg.norm(q, axis=1, keepdims=True), 1e-30)
                        num_valid = n - 70_001 if cases % 2 else n
                        vm = masks[(cases // 2) % 2]
                        bias = torch.from_numpy(_group_bias_case(rng, nq, groups, kind)).to(dev)
                        args = (torch.from_numpy(np.ascontiguousarray(q, np.float32)).to(dev),
                                codes_d, books_d, rn, num_valid, k, metric, vm,
                                exact_lut, packed, bias, gids_d)
                        what = (f"fused_adc_topk[group_bias] {kind} m={m} ksub={ksub} "
                                f"G={groups} {'f32' if exact_lut else 'bf16'} LUT Q={nq} "
                                f"k={k} {metric.name} num_valid={num_valid} "
                                f"filtered={(cases // 2) % 2 == 1}")
                        ref = fused_adc_topk_reference(*args)
                        got = fused_adc_topk(*args)
                        max_err = max(max_err, _max_diff(torch, got, ref))
                        if kind == "integer":
                            _twice_identical(torch, fused_adc_topk, args, ref, what)
                        else:
                            _identical(torch, got, ref, what)
                        cases += 1
    return cases, max_err


def _host_buckets(rng, ids, groups, bsize, payload, norms, dead):
    """The rows of each group laid out as an IVF index lays its buckets out
    ([G, B] slots, each bucket's rows first in a shuffled order, −1
    padding past its fill, tombstoned rows' slots −1 inside it): (codes,
    ids, norms, fill) on the host."""
    codes = np.zeros((groups, bsize) + payload.shape[1:], payload.dtype)
    bid = np.full((groups, bsize), -1, np.int32)
    bn = np.zeros((groups, bsize), np.float32)
    fill = np.zeros(groups, np.int32)
    order = np.argsort(ids, kind="stable")
    starts = np.searchsorted(ids[order], np.arange(groups + 1))
    for g in range(groups):
        rows = order[starts[g]:starts[g + 1]].copy()
        rng.shuffle(rows)
        codes[g, :len(rows)] = payload[rows]
        bid[g, :len(rows)] = np.where(dead[rows], -1, rows)
        bn[g, :len(rows)] = norms[rows]
        fill[g] = len(rows)
    return codes, bid, bn, fill


def _bucket_cases(torch, dev, rng) -> tuple[int, float]:
    """The bucket kernel over a bucket layout (``fused_adc_topk(...,
    buckets=)``, IVF-PQ's scan) against the plain version over the same
    rows in row order, on the card: 200,003 rows in 1,500 buckets of up to
    260 slots, shuffled inside each bucket, with tombstoned slots (id −1
    inside the fill) and duplicate rows planted in other buckets (the tie
    goes to the lower row); 4-bit m=32 and 8-bit m=16 codes, f32 and bf16
    LUTs, the three metrics; 16 probed buckets a query with a tie at the
    cut, and one probed bucket with a fetch above its rows; batches 1, 8,
    33 and 256, k in {10, 400, 1100, 3000} (lists in shared and in device
    memory); the tombstones' mask, or times a filter, and num_valid inside
    the rows: identical, twice on integer data. Returns (cases, largest
    |score difference|)."""
    from metrovector_tpu_torch import DistanceMetric
    from metrovector_tpu_torch.index.pq import pack_codes4
    from metrovector_tpu_torch.ops.adc_kernel import (
        fused_adc_topk, fused_adc_topk_reference,
    )

    n, groups, bsize, cases, max_err = SPLIT_N, 1500, 260, 0, 0.0
    metrics = (DistanceMetric.L2, DistanceMetric.INNER_PRODUCT, DistanceMetric.COSINE)
    for kind in ("integer", "normal"):
        for packed, m, ksub in ((True, 32, 16), (False, 16, 256)):
            books = (rng.integers(0, 8, (m, ksub, 4)) if kind == "integer"
                     else rng.standard_normal((m, ksub, 4))).astype(np.float32)
            codes = rng.integers(0, ksub, (n, m)).astype(np.uint8)
            gids = rng.integers(0, groups, n).astype(np.int32)
            codes[n // 2:n // 2 + 1000] = codes[:1000]  # twins in other buckets
            gids[n // 2:n // 2 + 1000] = (gids[:1000] + 7) % groups
            recon = np.concatenate([books[j][codes[:, j]] for j in range(m)], 1)
            rn = (recon.astype(np.float64) ** 2).sum(1).astype(np.float32)
            dead = rng.random(n) < 0.05
            mask = (~dead).astype(np.float32)
            filt = mask * (rng.random(n) < 0.5)
            stored = pack_codes4(codes) if packed else codes
            bl = _host_buckets(rng, gids, groups, bsize, stored, rn, dead)
            layout = tuple(torch.from_numpy(a).to(dev) for a in bl)
            codes_d, books_d, rn_d, gids_d = (torch.from_numpy(a).to(dev)
                                              for a in (stored, books, rn, gids))
            for exact_lut in (True, False):
                for nq, k, probes in ((1, 10, 16), (8, 400, 16), (33, 400, 16),
                                      (256, 400, 16), (33, 1100, 16), (8, 3000, 16),
                                      (1, 400, 1)):
                    metric = metrics[cases % 3]
                    q = (rng.integers(0, 8, (nq, m * 4)) if kind == "integer"
                         else rng.standard_normal((nq, m * 4))).astype(np.float32)
                    if metric == DistanceMetric.COSINE:
                        q /= np.maximum(np.linalg.norm(q, axis=1, keepdims=True), 1e-30)
                    bias = np.full((nq, groups), -1e30, np.float32)
                    for r in range(nq):
                        probed = rng.choice(groups, probes, replace=False)
                        vals = (rng.integers(-3000, 3000, probes) if kind == "integer"
                                else rng.standard_normal(probes) * 1000).astype(np.float32)
                        vals[1:2] = vals[0]  # tied buckets at the cut
                        bias[r, probed] = vals
                    num_valid = n - n // 3 if cases % 2 else n
                    vm = torch.from_numpy(filt if (cases // 2) % 2 else mask).to(dev)
                    args = (torch.from_numpy(q).to(dev), codes_d, books_d, rn_d, num_valid,
                            k, metric, vm, exact_lut, packed,
                            torch.from_numpy(bias).to(dev), gids_d)
                    ref = fused_adc_topk_reference(*args)

                    def run(*a):
                        return fused_adc_topk(*a, buckets=layout)

                    got = run(*args)
                    what = (f"fused_adc_topk[buckets] {kind} m={m} ksub={ksub} "
                            f"{'f32' if exact_lut else 'bf16'} LUT Q={nq} k={k} "
                            f"{probes} probed {metric.name} num_valid={num_valid}")
                    max_err = max(max_err, _max_diff(torch, got, ref))
                    if kind == "integer":
                        _twice_identical(torch, run, args, ref, what)
                    else:
                        _identical(torch, got, ref, what)
                    if probes == 1 and not bool((got[1][:, -1] == -1).all()):
                        raise AssertionError(f"{what}: a fetch above the probed rows "
                                             "filled every slot")
                    cases += 1
    return cases, max_err


def _max_diff(torch, got, ref) -> float:
    """The largest |score difference| of two results over slots both fill."""
    both = torch.isfinite(got[0]) & torch.isfinite(ref[0])
    return float((got[0] - ref[0]).abs()[both].max()) if bool(both.any()) else 0.0


def _ivf_exact_on_card(torch, dev) -> int:
    """A small IVFIndex on the card: with nprobe == num_buckets its search
    is exact search (recall@10 1.0 against a float64 oracle, ties counted
    right); returns the number of buckets."""
    from metrovector_tpu_torch import DistanceMetric
    from metrovector_tpu_torch.index.ivf import IVFIndex

    rng = np.random.default_rng(SEED + 12)
    x = _clustered_u8_corpus(rng, 20_000, D_MAIN, ncenters=64)
    norms = (x.astype(np.float64) ** 2).sum(1).astype(np.float32)
    idx = IVFIndex.build(x, norms, DistanceMetric.L2, num_clusters=32, iters=4,
                         device="cuda")
    q = _pq_queries(rng, x, 64)
    res = idx.search(q, k=K_PQ, nprobe=idx.num_buckets)
    x64 = torch.from_numpy(x).to(dev, torch.float64)
    rec = _recall_on_card(torch, x64, (x64 * x64).sum(1), q, res.indices, K_PQ)
    if rec != 1.0:
        raise AssertionError(f"IVFIndex full probe recall@10 {rec} != 1")
    return idx.num_buckets


def _ivfpq_host_split(torch, dev, idx, host) -> dict:
    """IVFPQIndex.search's scan steps at rerank 400 one at a time (its code,
    unchanged, repeated here with a synchronize after each): the query
    upload, coarse_scores, the sort that finds the nprobe-th score, the
    bias, adc_lut, K2 (its wrapper computes its own LUT), K3 with the b0
    shift, the readbacks and the finalize, each a host-clock median in ms
    over the batches; beside them the device ms of adc_lut, K2 and K3
    (device_ms) and the host µs of one K2 and one K3 wrapper call (the
    enqueue alone)."""
    from metrovector_tpu_torch import DistanceMetric
    from metrovector_tpu_torch.engine import ids_for_rows
    from metrovector_tpu_torch.index.ivf import coarse_scores
    from metrovector_tpu_torch.ops.adc_kernel import adc_lut, fused_adc_topk
    from metrovector_tpu_torch.ops.distances import distances_np
    from metrovector_tpu_torch.ops.gather_kernel import rescore_candidates
    from metrovector_tpu_torch.utils.timing import device_ms

    L2, fetch = DistanceMetric.L2, RERANK
    steps = {k: [] for k in ("upload", "coarse", "sort", "bias", "lut", "k2", "k3",
                             "readback", "finalize")}
    bk = (idx.buckets, idx.bucket_ids, idx.bucket_norms, idx.bucket_fill)

    def k2(p):
        return fused_adc_topk(p[0], idx.codes_row, idx._books, idx.rnorms_row,
                              idx.num_vectors, fetch, L2, valid_mask=idx.row_valid,
                              packed4=idx.packed4, group_bias=p[1],
                              group_ids=idx.row_bucket, buckets=bk)

    def k3(p):
        return rescore_candidates(p[0], idx.db, idx.db_norms, p[1], K_PQ, L2,
                                  tie="position")

    def sync():
        torch.cuda.synchronize()
        return time.perf_counter()

    for qh in host:
        t = [sync()]
        q = np.ascontiguousarray(qh, np.float32)
        qnorms = np.einsum("ij,ij->i", q, q, dtype=np.float64).astype(np.float32)
        qdev = torch.from_numpy(q).to(dev)
        t.append(sync())
        cdots, cscores = coarse_scores(qdev, idx.probe_centroids, L2)
        t.append(sync())
        kth = torch.sort(cscores, dim=1, descending=True).values[:, IVF_NPROBE - 1:IVF_NPROBE]
        t.append(sync())
        sel = cscores >= kth
        b0 = torch.where(sel, cdots, float("-inf")).amax(dim=1, keepdim=True)
        bias = torch.where(sel, cdots - b0, -1e30)
        t.append(sync())
        adc_lut(qdev, idx._books, False)
        t.append(sync())
        s, i = k2((qdev, bias))
        t.append(sync())
        s = s + 2.0 * b0
        s, i = k3((qdev, i))
        t.append(sync())
        s, i = s.cpu().numpy(), i.cpu().numpy()
        t.append(time.perf_counter())
        dist = np.where(i >= 0, distances_np(s, L2, qnorms), np.inf)
        ids_for_rows(idx.host_ids, i)
        t.append(time.perf_counter())
        for key, a, b in zip(steps, t, t[1:]):
            steps[key].append((b - a) * 1e3)
    out = {key: float(np.median(v)) for key, v in steps.items()}
    qs = [torch.from_numpy(np.ascontiguousarray(h, np.float32)).to(dev) for h in host]
    pins = [(q, idx._scan_bias(q, IVF_NPROBE)[0]) for q in qs]
    lut = lambda q: adc_lut(q, idx._books, False)  # noqa: E731
    lut(qs[0])
    out["lut_device"] = device_ms(lut, qs, dev)
    out["k2_device"] = device_ms(k2, pins, dev)
    cands = [(q, k2(p)[1]) for q, p in zip(qs, pins)]
    out["k3_device"] = device_ms(k3, cands, dev)
    for key, fn, inputs in (("k2_host_us", k2, pins), ("k3_host_us", k3, cands)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for x in inputs:
            fn(x)
        out[key] = (time.perf_counter() - t0) / len(inputs) * 1e6
        torch.cuda.synchronize()
    return out


def phase_ivfpq_path(torch, dev, card):
    """The IVF-PQ path end to end at full width (module docstring, phase
    12). Returns (the variant's max |diff| against plain, its launches on
    the main path, the timed cell's numbers)."""
    from metrovector_tpu_torch import Builder, DistanceMetric, Reader
    from metrovector_tpu_torch.index.ivfpq import IVFPQIndex, train_ivfpq
    from metrovector_tpu_torch.index.pq import pack_codes4
    from metrovector_tpu_torch.ops.adc_kernel import fused_adc_topk, fused_adc_topk_reference
    from metrovector_tpu_torch.ops.gather_kernel import rescore_candidates
    from metrovector_tpu_torch.ops.topk_kernel import fused_topk
    from metrovector_tpu_torch.utils.timing import cuda_ms, device_ms, sync_time

    L2 = DistanceMetric.L2
    t0 = time.perf_counter()
    cases, max_err = _group_cases(torch, dev, np.random.default_rng(SEED + 11))
    say(f"  fused_adc_topk[group_bias] in row order (grouped on the card, then the "
        f"bucket kernel) vs plain: {cases} cases identical, max |score diff| "
        f"{max_err:.3g} ({time.perf_counter() - t0:.1f} s)")
    t0 = time.perf_counter()
    bcases, berr = _bucket_cases(torch, dev, np.random.default_rng(SEED + 13))
    max_err = max(max_err, berr)
    say(f"  fused_adc_topk[group_bias] over a bucket layout vs plain: {bcases} cases "
        f"identical, max |score diff| {berr:.3g} ({time.perf_counter() - t0:.1f} s)")
    buckets_small = _ivf_exact_on_card(torch, dev)
    say(f"  IVFIndex 20,000 x 128, nprobe = num_buckets = {buckets_small}: "
        "recall@10 1.0000, exact search")

    rng = np.random.default_rng(SEED)  # the suite's corpus: seed 7
    x = _clustered_u8_corpus(rng, N_MAIN, D_MAIN)
    x64 = torch.from_numpy(x).to(dev, torch.float64)
    norms64 = (x64 * x64).sum(1)
    queries = {bsz: _pq_queries(rng, x, bsz) for bsz in IVF_BATCHES}
    counts = {"fused_adc_topk[group_bias]": 0, "rescore_candidates": 0}
    cell, recalls, p50 = None, {}, {}
    keep = {"pins": {}}  # sift1m-ivfpq's index and timed inputs, for phase 15
    tmp = tempfile.TemporaryDirectory()
    try:
        for name, m, ksub, packed in IVFPQ_CONFIGS:
            t0 = time.perf_counter()
            cents, assign, books, codes = train_ivfpq(
                x, IVF_CLUSTERS, m=m, ksub=ksub, iters=IVF_ITERS, device=dev)
            t_train = time.perf_counter() - t0
            stored = pack_codes4(codes) if packed else codes
            path = os.path.join(tmp.name, f"{name}.mvt")
            t0 = time.perf_counter()
            b = Builder()
            b.add_vector_space("sift", dim=D_MAIN, metric=L2)
            b.add_vectors("sift", x)
            b.set_ivf_index("sift", cents, assign, nprobe=IVF_NPROBE)
            b.set_pq_index("sift", books, stored, residual=True, packed4=packed)
            b.build().save(path)
            t_save = time.perf_counter() - t0
            if packed:
                _keep_for_p17(name, path)
            t0 = time.perf_counter()
            idx = IVFPQIndex.from_space(Reader.open(path).vector_space("sift"),
                                        device="cuda")
            torch.cuda.synchronize()
            t_open = time.perf_counter() - t0
            if not (idx.packed4 == packed and np.array_equal(idx.centroids, cents)
                    and np.array_equal(idx.codebooks, books)
                    and np.array_equal(idx.codes_row.cpu().numpy(), stored)):
                raise AssertionError(f"{name}: from_space did not reuse the file's index")
            say(f"  {name}: train_ivfpq (C={IVF_CLUSTERS}, m={m}, ksub={ksub}, "
                f"iters {IVF_ITERS}) on the card {t_train:.1f} s; file written "
                f"{t_save:.1f} s; Reader.open + IVFPQIndex.from_space {t_open:.2f} s; "
                f"{idx.num_buckets} buckets of {idx.bucket_rows} rows")

            # The main path: every count at 0, the searches, counts read.
            # "scan" is one launch of the bucket variant, "probe" plain
            # PyTorch; each re-rank one launch of the rescore kernel.
            for fn in (fused_adc_topk, rescore_candidates, fused_topk):
                fn.launches = 0
            fused_adc_topk.group_launches = 0
            results = {}
            for bsz, q in queries.items():
                for mode in ("scan", "probe"):
                    for rr in IVF_RERANKS:
                        before = (fused_adc_topk.launches, fused_adc_topk.group_launches,
                                  rescore_candidates.launches)
                        res = idx.search(q, k=K_PQ, nprobe=IVF_NPROBE, rerank=rr,
                                         mode=mode)
                        scan = int(mode == "scan")
                        if (fused_adc_topk.launches, fused_adc_topk.group_launches,
                                rescore_candidates.launches) != (
                                before[0] + scan, before[1] + scan, before[2] + 1):
                            raise AssertionError(f"{name} {mode}: not one launch of "
                                                 "each kernel of its route")
                        results[(bsz, mode, rr)] = res
            counts["fused_adc_topk[group_bias]"] += fused_adc_topk.group_launches
            counts["rescore_candidates"] += rescore_candidates.launches
            if fused_topk.launches or fused_adc_topk.launches != fused_adc_topk.group_launches:
                raise AssertionError(f"{name}: the IVF-PQ path ran another kernel")

            for (bsz, mode, rr), res in results.items():
                rec = _recall_on_card(torch, x64, norms64, queries[bsz], res.indices, K_PQ)
                recalls[(name, bsz, mode, rr)] = rec
                if rr == 400 and rec < 0.99:
                    raise AssertionError(f"{name} {mode} batch {bsz}: recall@10 "
                                         f"{rec} < 0.99 at rerank 400")
            say(f"  {name} recall@10 against the float64 oracle on the card: " + ", ".join(
                f"batch {b} {md} rerank {r} {recalls[(name, b, md, r)]:.4f}"
                for b in IVF_BATCHES for md in ("scan", "probe") for r in IVF_RERANKS))

            # The bucket kernel at the main path's inputs (batches 1, 8 and
            # 256, fetch 400, the search's bf16 LUT) against its plain version
            # over the rows in row order; the scan itself with no host
            # synchronization; the kernel's time beside both bounds.
            bk = (idx.buckets, idx.bucket_ids, idx.bucket_norms, idx.bucket_fill)
            fill_live = torch.bincount(idx.row_bucket[idx.row_bucket >= 0].long(),
                                       minlength=idx.num_buckets).double()
            cols = idx.codes_row.shape[1]
            for bsz in IVF_KERNEL_BATCHES:
                qd = torch.from_numpy(_pq_queries(rng, x, bsz)).to(dev)
                bias, _ = idx._scan_bias(qd, IVF_NPROBE)
                gargs = (idx.codes_row, idx._books, idx.rnorms_row, idx.num_vectors,
                         400, L2, idx.row_valid, False, packed)
                got = fused_adc_topk(qd, *gargs, bias, idx.row_bucket, buckets=bk)
                ref = fused_adc_topk_reference(qd, *gargs, bias, idx.row_bucket)
                _identical(torch, got, ref, f"{name} batch {bsz}: the bucket kernel at "
                           "the main path's inputs")
                max_err = max(max_err, _max_diff(torch, got, ref))
                idx._masked_scan(qd, 400, IVF_NPROBE)
                torch.cuda.synchronize()
                torch.cuda.set_sync_debug_mode("error")  # a host sync raises
                try:
                    _, i_scan = idx._masked_scan(qd, 400, IVF_NPROBE)
                finally:
                    torch.cuda.set_sync_debug_mode("default")
                if not torch.equal(i_scan, ref[1]):
                    raise AssertionError(f"{name} batch {bsz}: _masked_scan's indices "
                                         "differ from the plain version's")
                # 20 calls: their host time (under 0.7 ms each) stays inside
                # device_ms's sleep of about 25 ms, so the device never waits.
                qs = [torch.from_numpy(_pq_queries(rng, x, bsz)).to(dev)
                      for _ in range(20)]
                pins = [(q, idx._scan_bias(q, IVF_NPROBE)[0]) for q in qs]

                if name == IVFPQ_CONFIGS[0][0]:
                    keep["idx"], keep["pins"][bsz] = idx, pins

                def k2(p):
                    return fused_adc_topk(p[0], *gargs, p[1], idx.row_bucket, buckets=bk)

                def k2_plain(p):
                    return fused_adc_topk_reference(p[0], *gargs, p[1], idx.row_bucket)

                for fn in (k2, k2_plain):
                    fn(pins[0])
                p1 = cuda_ms(k2_plain, pins[:3], dev)
                a1 = device_ms(k2, pins, dev)
                a2 = device_ms(k2, pins, dev)
                p2 = cuda_ms(k2_plain, pins[:3], dev)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for p in pins:
                    k2(p)
                host_us = (time.perf_counter() - t0) / len(pins) * 1e6
                torch.cuda.synchronize()
                # Bounds from this run's bias: every row's bytes, and
                # the probed work: 2·m adds per probed (query, row) pair, the
                # codes, id, norm and mask of each row of the buckets some
                # query probes, once; both with the LUT, the bias, the outputs.
                probed = bias > -1e28
                pairs = int((probed.double() @ fill_live).sum())
                union_rows = int(fill_live[probed.any(0)].sum())
                tail = bsz * m * ksub * 2 + bsz * idx.num_buckets * 4 + bsz * 400 * 8
                b_rows = bound(2 * m * pairs, idx.num_vectors * (cols + 12) + tail)
                b_probed = bound(2 * m * pairs, union_rows * (cols + 12) + tail)
                row = {"ms": (a1 + a2) / 2, "plain_ms": (p1 + p2) / 2, "bound": b_probed,
                       "bound_rows": b_rows, "pairs": pairs, "host_us": host_us}
                say(f"  timing {name} bucket kernel batch={bsz} fetch=400 bf16 LUT: "
                    f"{row['ms']:.4f} ms on the device ({a1:.4f}, {a2:.4f}; wrapper "
                    f"{host_us:.1f} us on the host; plain {row['plain_ms']:.4f}) | "
                    f"{pairs} probed (query, row) pairs, {union_rows} rows in the "
                    f"probed buckets' union | bound of the probed work "
                    f"{b_probed[0]:.4f} ms ({b_probed[1]}), share "
                    f"{b_probed[0] / row['ms']:.1%}; bound of every row {b_rows[0]:.4f} "
                    f"ms ({b_rows[1]}), share {b_rows[0] / row['ms']:.1%} | {card}")
                if bsz == 256 and (cell is None or packed):
                    cell = row  # the kernels line reports sift1m-ivfpq4
                if bsz == 256:
                    dead = torch.full_like(bias, -1e30)
                    t_scan = cuda_ms(lambda p: fused_adc_topk(p[0], *gargs), pins, dev)
                    t_dead = device_ms(lambda p: fused_adc_topk(
                        p[0], *gargs, dead, idx.row_bucket, buckets=bk), pins, dev)
                    say(f"  {name} batch 256: the scan of every row without the bias "
                        f"{t_scan:.4f} ms; the bucket kernel with no bucket probed "
                        f"{t_dead:.4f} ms | {card}")
            for bsz in IVF_KERNEL_BATCHES:
                host = [_pq_queries(rng, x, bsz) for _ in range(15)]
                split = _ivfpq_host_split(torch, dev, idx, host)
                say(f"  search() step by step, {name} scan batch={bsz} rerank=400 (host "
                    "ms, synchronized after each step; medians of 15): "
                    + ", ".join(f"{k_} {v:.4f}" for k_, v in split.items()
                                if not k_.endswith(("_us", "_device")))
                    + f"; device ms: adc_lut {split['lut_device']:.4f}, K2 "
                    f"{split['k2_device']:.4f}, K3 {split['k3_device']:.4f}; wrapper "
                    f"host us: K2 {split['k2_host_us']:.1f}, K3 {split['k3_host_us']:.1f} "
                    f"| {card}")

            # search() p50 and QPS in both modes: the batches of the issue
            # at both reranks, and more batches at rerank 400 for the
            # crossover of the two modes.
            points = sorted({(b, rr) for b in IVF_BATCHES for rr in IVF_RERANKS}
                            | {(b, 400) for b in IVF_CROSSOVER_BATCHES})
            for bsz, rr in points:
                host = [_pq_queries(rng, x, bsz) for _ in range(15)]
                for mode in ("scan", "probe"):
                    kw = dict(k=K_PQ, nprobe=IVF_NPROBE, rerank=rr, mode=mode)
                    idx.search(host[0], **kw)
                    ms = float(np.median([sync_time(idx.search, q, device=dev, **kw)[0]
                                          for q in host])) * 1e3
                    p50[(name, bsz, rr, mode)] = ms
                s_ms, p_ms = p50[(name, bsz, rr, "scan")], p50[(name, bsz, rr, "probe")]
                say(f"  {name} search() p50 batch={bsz} rerank={rr}: scan {s_ms:.4f} ms "
                    f"({bsz / s_ms * 1e3:.0f} QPS), probe {p_ms:.4f} ms "
                    f"({bsz / p_ms * 1e3:.0f} QPS) | {card}")
            faster = [b for b in IVF_CROSSOVER_BATCHES
                      if p50[(name, b, 400, "scan")] < p50[(name, b, 400, "probe")]]
            say(f"  {name} crossover (rerank 400): scan faster at batches {faster} of "
                f"{list(IVF_CROSSOVER_BATCHES)}; SCAN_CROSSOVER_BATCH stays "
                f"{IVFPQIndex.SCAN_CROSSOVER_BATCH} | {card}")
            del idx
            torch.cuda.empty_cache()
    finally:
        tmp.cleanup()
    say(f"phase 12 IVF-PQ path: ok (recall@10 at rerank 400 "
        + ", ".join(f"{n} {md} batch {b} {r:.4f}" for (n, b, md, rr), r in recalls.items()
                    if rr == 400 and b == 256)
        + f"; launches {counts})")
    return max_err, counts["fused_adc_topk[group_bias]"], cell, keep


# -- phase 13: the dense engine's precision ladder ---------------------------

N_GIST, D_GIST, GIST_SEED = 1_000_000, 960, 3  # benchmarks/suite.py:304-410
HIGH_K, HIGH_MARGIN = 10, 8
HIGH_SOURCE = CSRC + "topk_high_kernel.cu"
# The tensor-core scans' tile edges (a tile holds 2 NW queries, NW in 16 ..
# 128; a stage 64 rows): batches and a row count that ends mid-stage.
TILE_EDGE_BATCHES, TILE_EDGE_N, TILE_EDGE_D = (8, 64, 128, 129, 256), 100_037, (96, 1536)
# The kernel this replaces, from PERF.md (NVIDIA H100 80GB HBM3, 700 W):
# the mma.sync bf16x3 scan, in ms.
MMA_SYNC_HIGH_MS = {("gist1m", 256): 8.3215, ("gist1m", 64): 2.6154,
               ("phase 3 corpus", 32): 0.6460}
# Dense bf16 tensor-core rate of the H100 SXM data sheet at 700 W.
BF16_FLOPS = 989e12


def high_bound(nq: int, n: int, d: int, k: int) -> tuple[float, str]:
    """(bound_ms, bound_by) of the bf16x3 variant: its three products, 2 Q N
    D operations each, at the dense bf16 rate, or its bytes (the f32 corpus,
    norms and queries read once, the top k written once)."""
    t_ops = 6 * nq * n * d / BF16_FLOPS * 1e3
    t_bytes = (4 * (n * d + n + nq * d) + 8 * nq * k) / HBM_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def _acc_band(q, xmax: float, metric, d: int) -> np.ndarray:
    """Per-query bound on |kernel - plain| at "high" on float data: the
    same exact products, summed on the tensor cores and by three f32
    matmuls (engine.high_sum_bounds, in units of S <= |q| |x|); L2 doubles
    the dot and rounds 2 dot - |x|^2 on both sides; cosine rounds the 1/|x|
    factor."""
    from metrovector_tpu_torch import DistanceMetric
    from metrovector_tpu_torch.engine import high_sum_bounds

    c = sum(high_sum_bounds(d))
    if metric == DistanceMetric.COSINE:
        return np.full(q.shape[0], c + 2.0**-22)
    qn = np.linalg.norm(q.astype(np.float64), axis=1)
    if metric == DistanceMetric.L2:
        return 2 * c * qn * xmax + 2.0**-23 * (2 * qn * xmax + xmax * xmax)
    return c * qn * xmax


def _bf16x3_scores64(torch, q, x, norms, metric):
    """The near-tie oracle: ``score(r, rows)``, the float64 scores on the
    card of query ``r`` against ``rows`` from the exact bf16x3 products
    that both the kernel and its plain version sum in f32."""
    from metrovector_tpu_torch import DistanceMetric
    from metrovector_tpu_torch.ops.distances import bf16x3_dots

    def score(r, rows):
        idx = torch.as_tensor(rows, dtype=torch.long, device=x.device)
        dots = bf16x3_dots(q[r : r + 1], x[idx], torch.float64)[0]
        n64 = norms[idx].double()
        if metric == DistanceMetric.L2:
            dots = 2.0 * dots - n64
        elif metric == DistanceMetric.COSINE:
            dots = dots / torch.sqrt(torch.clamp(n64, min=1e-30))
        return dots.cpu().numpy()

    return score


def _compare_high(got, ref, tol, s64, what) -> float:
    """The variant (got) against its plain version (ref) on float data:
    unfilled slots equal, scores within ``tol`` per query, and rows that
    differ only at near-ties (their f64 bf16x3 scores, ``s64(r, rows)``
    (_bf16x3_scores64), within ``tol`` of the k-th). Returns the largest
    score difference."""
    s_k, i_k = (t.cpu().numpy() for t in got)
    s_r, i_r = (t.cpu().numpy() for t in ref)
    if not np.array_equal(i_k == -1, i_r == -1):
        raise AssertionError(f"{what}: unfilled slots differ")
    fin = i_r >= 0
    with np.errstate(invalid="ignore"):
        diff = np.where(fin, np.abs(s_k - s_r), 0.0)
    if (diff > tol[:, None]).any():
        raise AssertionError(f"{what}: score difference {diff.max()} above {tol.min()}")
    for r in range(i_k.shape[0]):
        odd = sorted(set(i_k[r][i_k[r] >= 0]) ^ set(i_r[r][i_r[r] >= 0]))
        if odd:
            near = np.abs(s64(r, odd) - s_r[r][fin[r]][-1]) <= tol[r]
            if not near.all():
                raise AssertionError(f"{what}: query {r} differs outside the tie band")
    return float(diff.max())


def _high_cases(torch, dev, rng) -> tuple[int, float]:
    """Phase 13 (a): fused_topk(precision="high") against its plain version
    on the card over the three metrics, batches 1, 33 and 255, k in {10,
    100, 257} and D in {100, 128, 960, 1536}. First 200,003 integer rows in
    [0, 16) with twins across splits (num_valid ending inside a split, a
    mask that empties whole splits): L2 and IP identical to the plain
    version and twice identical; cosine (normalized queries) twice
    identical and within the band. Then 20,011 N(0, 1) rows with a mask and
    num_valid below N, within the band (_acc_band). Returns (cases, max
    |score diff| on float data)."""
    from metrovector_tpu_torch import DistanceMetric
    from metrovector_tpu_torch.ops.topk_kernel import fused_topk, fused_topk_reference

    metrics = (DistanceMetric.L2, DistanceMetric.INNER_PRODUCT, DistanceMetric.COSINE)

    def high(*args):
        return fused_topk(*args, precision="high")

    def plain(*args):
        return fused_topk_reference(*args, precision="high")

    def unit(q):
        return (q / np.maximum(np.linalg.norm(q, axis=1, keepdims=True), 1e-30)
                ).astype(np.float32)

    cases, max_err = 0, 0.0
    mask = np.ones(SPLIT_N, np.float32)
    mask[40_000:120_000] = 0
    mask_d = torch.from_numpy(mask).to(dev)
    for d in (100, 128, 960, 1536):
        x = torch.from_numpy(_twin_rows(rng, SPLIT_N, d, 16)).to(dev)
        norms = (x.double() ** 2).sum(1).float()
        xmax = float(norms.max().sqrt())
        q_int = rng.integers(0, 16, (255, d)).astype(np.float32)
        for metric in metrics:
            cosine = metric == DistanceMetric.COSINE
            q_all = unit(q_int) if cosine else q_int
            s64 = (_bf16x3_scores64(torch, torch.from_numpy(q_all).to(dev), x, norms,
                                    metric) if cosine else None)
            for nq in (1, 33, 255):
                q = torch.from_numpy(np.ascontiguousarray(q_all[:nq])).to(dev)
                for k in (10, 100, 257):
                    variant = (cases + cases // 4) % 4
                    num_valid = SPLIT_N - 70_001 if variant & 1 else SPLIT_N
                    args = (q, x, norms, num_valid, k, metric,
                            mask_d if variant & 2 else None)
                    what = (f"fused_topk[high] integer D={d} Q={nq} k={k} {metric.name} "
                            f"num_valid={num_valid} mask={bool(variant & 2)}")
                    if cosine:
                        got = high(*args)
                        _identical(torch, high(*args), got, what + " (run twice)")
                        _compare_high(got, plain(*args),
                                      _acc_band(q_all[:nq], xmax, metric, d),
                                      s64, what)
                    else:
                        _twice_identical(torch, high, args, plain(*args), what)
                    cases += 1
        if d in (128, 960):  # the wgmma tiles' edges, rows ending mid-stage
            m = TILE_EDGE_N
            q_edge = rng.integers(0, 16, (max(TILE_EDGE_BATCHES), d)).astype(np.float32)
            for nq in TILE_EDGE_BATCHES:
                q = torch.from_numpy(q_edge[:nq]).to(dev)
                for metric in metrics[:2]:
                    k = (10, 100, 257)[cases % 3]
                    args = (q, x[:m], norms[:m], m - 29 if cases & 1 else m, k, metric,
                            mask_d[:m] if cases & 2 else None)
                    _twice_identical(torch, high, args, plain(*args),
                                     f"fused_topk[high] tile edge D={d} Q={nq} N={m} "
                                     f"k={k} {metric.name}")
                    cases += 1
        del x, norms
        torch.cuda.empty_cache()
    n = 20_011
    for d in (100, 128, 960, 1536):
        x = torch.from_numpy(rng.standard_normal((n, d)).astype(np.float32)).to(dev)
        norms = (x.double() ** 2).sum(1).float()
        xmax = float(norms.max().sqrt())
        q_f = rng.standard_normal((255, d)).astype(np.float32)
        vm = torch.from_numpy((rng.random(n) > 0.2).astype(np.float32)).to(dev)
        for metric in metrics:
            q_all = unit(q_f) if metric == DistanceMetric.COSINE else q_f
            q_d = torch.from_numpy(q_all).to(dev)
            s64 = _bf16x3_scores64(torch, q_d, x, norms, metric)
            for nq in (1, 33, 255):
                for k in (10, 100, 257):
                    variant = cases % 4
                    args = (q_d[:nq].contiguous(), x, norms,
                            n - 77 if variant & 1 else n, k, metric,
                            vm if variant & 2 else None)
                    max_err = max(max_err, _compare_high(
                        high(*args), plain(*args),
                        _acc_band(q_all[:nq], xmax, metric, d), s64,
                        f"fused_topk[high] normal D={d} Q={nq} k={k} {metric.name} "
                        f"variant {variant}"))
                    cases += 1
        del x, norms
        torch.cuda.empty_cache()
    torch.cuda.synchronize()
    return cases, max_err


def _scan_ratio(torch, q, x, norms, s_h, i_h, metric, d) -> float:
    """The largest |"high" score - f64 score| over the fetched rows, as a
    share of the scan's raw bound (engine.high_dot_bounds: the split and
    the tensor cores' sums, in units of S = sum |q_d x_d|); cosine adds the
    roundings of 1/|x| and of the product, 2^-22 |s|."""
    from metrovector_tpu_torch import DistanceMetric
    from metrovector_tpu_torch.engine import high_dot_bounds

    scan = high_dot_bounds(d)[0]
    rows = x[i_h.long().clamp(min=0)].double()  # [Q, k, D]
    q64 = q.double()[:, None, :]
    dot = (rows * q64).sum(-1)
    s_abs = (rows.abs() * q64.abs()).sum(-1)
    if metric == DistanceMetric.COSINE:
        inv = 1.0 / torch.sqrt(norms[i_h.long()].double())
        s64 = dot * inv
        lim = scan * s_abs * inv + 2.0**-22 * s64.abs()
    else:
        s64, lim = dot, scan * s_abs
    ok = i_h >= 0
    return float(((s_h.double() - s64).abs() / lim)[ok].max())


def _certificate_cases(torch, dev, rng) -> list[str]:
    """Phase 13 (b), the certificate on the card: the scan's measured error
    against its raw bound on data where nothing cancels (rows and queries
    in [0, 1), inner product, D in {100, 960, 1536}) and on N(0, 1) rows;
    then through Builder -> Reader.open -> SearchEngine(device="cuda"), the
    planted near-tie corpus of tests/test_verified_high.py and a corpus of
    40 copies of one row, where high_verified must equal highest bit for
    rank by falling back. Returns the lines to print."""
    from metrovector_tpu_torch import Builder, DistanceMetric, Reader, SearchEngine
    from metrovector_tpu_torch.ops.topk_kernel import fused_topk

    lines = []
    gen = torch.Generator(device=dev).manual_seed(SEED)
    worst = 0.0
    for d in (100, 960, 1536):
        for kind in ("positive", "normal"):
            if kind == "positive":
                x = torch.rand((100_000, d), generator=gen, device=dev)
                q = torch.rand((64, d), generator=gen, device=dev)
                metric = DistanceMetric.INNER_PRODUCT
            else:
                x = torch.randn((100_000, d), generator=gen, device=dev)
                q = torch.randn((64, d), generator=gen, device=dev)
                q = q / q.norm(dim=1, keepdim=True)
                metric = DistanceMetric.COSINE
            norms = (x.double() ** 2).sum(1).float()
            s_h, i_h = fused_topk(q, x, norms, x.shape[0], HIGH_K + HIGH_MARGIN,
                                  metric, precision="high")
            ratio = _scan_ratio(torch, q, x, norms, s_h, i_h, metric, d)
            worst = max(worst, ratio)
            lines.append(f"{kind} D={d} {metric.name} {ratio:.4f}")
            del x
    if worst >= 1.0:
        raise AssertionError(f"the scan's error passed its bound: {lines}")
    with tempfile.TemporaryDirectory() as tmp:
        base = np.full(32, 100.0, np.float32)
        near = (base + 0.1 * rng.standard_normal((300, 32))).astype(np.float32)
        q_near = (base + 0.1 * rng.standard_normal((9, 32))).astype(np.float32)
        dup = rng.standard_normal((300, 32)).astype(np.float32)
        copies = rng.choice(300, 40, replace=False)
        dup[copies] = 3 * dup[copies[0]]
        q_dup = np.stack([dup[copies[0]] + 1e-3 * rng.standard_normal(32),
                          dup[copies[0]]]).astype(np.float32)
        for name, data, q, metric in (
                ("near-tie", near, q_near, DistanceMetric.L2),
                ("40 copies", dup, q_dup, DistanceMetric.COSINE)):
            path = os.path.join(tmp, name.replace(" ", "_") + ".mvt")
            b = Builder()
            b.add_vector_space("v", dim=32, metric=metric)
            b.add_vectors("v", data)
            b.build().save(path)
            space = Reader.open(path).vector_space("v")
            ver = SearchEngine(space, device="cuda", precision="high_verified")
            got = ver.search(q, k=HIGH_K)
            want = SearchEngine(space, device="cuda").search(q, k=HIGH_K)
            if not (np.array_equal(got.indices, want.indices)
                    and np.array_equal(got.scores, want.scores)):
                raise AssertionError(f"{name}: high_verified differs from highest")
            if ver.verify_stats["fallbacks"] == 0:
                raise AssertionError(f"{name}: the certificate never failed")
            lines.append(f"{name} corpus: identical to highest, verify_stats "
                         f"{ver.verify_stats}")
    return lines


def _gist_corpus():
    """benchmarks/suite.py's gist1m rows: default_rng(3), 1M x 960 N(0, 1)
    drawn in f64 and cast (in row blocks: the same stream). Returns the rows
    and the generator, whose stream goes on to the queries."""
    g = np.random.default_rng(GIST_SEED)
    x = np.empty((N_GIST, D_GIST), np.float32)
    for r0 in range(0, N_GIST, 50_000):
        x[r0 : r0 + 50_000] = g.standard_normal((min(50_000, N_GIST - r0), D_GIST))
    return x, g


def _cosine_recall(torch, x64, inv64, q, rows, k) -> float:
    """recall@k of ``rows`` against the float64 cosine oracle on the card
    (a row within the k-th best similarity counts)."""
    qd = torch.from_numpy(q).to(x64.device, torch.float64)
    sim = (qd @ x64.T) * inv64[None, :]
    kth = torch.topk(sim, k, dim=1).values[:, -1:]
    r = torch.from_numpy(rows.astype(np.int64)).to(x64.device)
    got = torch.gather(sim, 1, r.clamp(min=0))
    return float(((got >= kth) & (r >= 0)).sum()) / (q.shape[0] * k)


def _time_high_cell(torch, dev, card, engines, name, batches, metric, qgen, exact):
    """The variant, its plain version, K1 "highest", K3's re-score at R =
    k + margin and search() p50 at the three precisions, at each batch of
    one cell. The variant is held against its plain version on every timed
    input: identical where the data is ``exact`` (small integers), else
    within the band (_compare_high). Returns ({batch: {...}} of
    milliseconds, max |score diff|)."""
    from metrovector_tpu_torch.ops.distances import rescore_topk
    from metrovector_tpu_torch.ops.topk_kernel import fused_topk, fused_topk_reference
    from metrovector_tpu_torch.utils.timing import cuda_ms, device_ms, sync_time

    sp = engines["high_verified"].space
    kf = HIGH_K + HIGH_MARGIN
    xmax = float(sp.norms.max().sqrt())
    out, max_err = {}, 0.0
    for nq in batches:
        hosts = [qgen(nq) for _ in range(10)]
        qs = [sp.prepare_queries(h).qdev for h in hosts]

        def kern(q):
            return fused_topk(q, sp.data, sp.norms, sp.num_valid, kf, metric,
                              precision="high")

        def plain(q):
            return fused_topk_reference(q, sp.data, sp.norms, sp.num_valid, kf,
                                        metric, precision="high")

        def highest(q):
            return fused_topk(q, sp.data, sp.norms, sp.num_valid, HIGH_K, metric)

        outs = [kern(q) for q in qs]
        cands = [o[1] for o in outs]
        for i, (q, got) in enumerate(zip(qs, outs)):
            what = f"{name} batch {nq} query set {i}: fused_topk[high] k={kf}"
            if exact:
                _identical(torch, got, plain(q), what)
            else:
                max_err = max(max_err, _compare_high(
                    got, plain(q),
                    _acc_band(q.cpu().numpy(), xmax, metric, sp.dim),
                    _bf16x3_scores64(torch, q, sp.data, sp.norms, metric), what))
        del outs
        highest(qs[0])
        p1 = cuda_ms(plain, qs[:3], dev)
        k1 = cuda_ms(kern, qs, dev)
        k2 = cuda_ms(kern, qs, dev)
        p2 = cuda_ms(plain, qs[:3], dev)
        f32 = cuda_ms(highest, qs, dev)
        pairs = list(zip(qs, cands))

        def rescore(pair):
            return rescore_topk(pair[0], sp.data, sp.norms, pair[1], HIGH_K, metric)

        rescore(pairs[0])
        k3 = device_ms(rescore, pairs, dev)
        p50 = {p: float(np.median([sync_time(e.search, h, k=HIGH_K, device=dev)[0]
                                   for h in hosts])) * 1e3
               for p, e in engines.items()}
        row = {"ms": (k1 + k2) / 2, "runs": (k1, k2), "plain_ms": (p1 + p2) / 2,
               "highest_ms": f32, "rescore_ms": k3, "p50": p50,
               "bound": high_bound(nq, sp.num_valid, sp.dim, kf)}
        out[nq] = row
        old = MMA_SYNC_HIGH_MS.get((name, nq))
        say(f"  {name} batch={nq}: fused_topk[high] k={kf} {row['ms']:.4f} ms (runs "
            f"{k1:.4f}, {k2:.4f}; bound {row['bound'][0]:.4f} ms by "
            f"{row['bound'][1]}, {row['bound'][0] / row['ms']:.1%}) | "
            + (f"the mma.sync kernel it replaces {old:.4f} (PERF.md) | " if old else "")
            + f"plain "
            f"{row['plain_ms']:.4f} | K1 highest k={HIGH_K} {f32:.4f} | K3 rescore "
            f"R={kf} device {k3:.4f} | search() p50 " + ", ".join(
                f"{p} {v:.4f}" for p, v in p50.items()) + f" ms | {card}")
    say(f"  (c) {name}: fused_topk[high] held against its plain version on "
        f"{10 * len(batches)} timed query sets, "
        + ("identical" if exact else f"max |score diff| {max_err:.3g}"))
    return out, max_err


def phase_high_path(torch, dev, card, sift_path):
    """Phase 13 (module docstring). Returns the kernels-line figures of
    fused_topk[high]."""
    from metrovector_tpu_torch import DistanceMetric, Builder, Reader, SearchEngine
    from metrovector_tpu_torch.engine import VERIFY_SAFETY, DeviceSpace
    from metrovector_tpu_torch.ops.gather_kernel import rescore_candidates
    from metrovector_tpu_torch.ops.topk_kernel import fused_topk

    t_phase = time.perf_counter()
    rng = np.random.default_rng(SEED + 13)
    cases, max_err = _high_cases(torch, dev, rng)
    say(f"  (a) fused_topk[high] vs plain: {cases} cases identical or within the "
        f"band, max |score diff| on float data {max_err:.3g} "
        f"({time.perf_counter() - t_phase:.1f} s)")
    for line in _certificate_cases(torch, dev, rng):
        say(f"  (b) {line}")

    # (c) GIST1M through the public path, and the phase 3 corpus.
    cos = DistanceMetric.COSINE
    t0 = time.perf_counter()
    x, g = _gist_corpus()
    t_gen = time.perf_counter() - t0
    tmp = tempfile.TemporaryDirectory()
    try:
        path = os.path.join(tmp.name, "gist1m.mvt")
        t0 = time.perf_counter()
        b = Builder()
        b.add_vector_space("gist", dim=D_GIST, metric=cos, pad_dims=False)
        b.add_vectors("gist", x)
        b.build().save(path)
        del b, x
        t_build = time.perf_counter() - t0
        t0 = time.perf_counter()
        ver = SearchEngine(Reader.open(path).vector_space("gist"), device="cuda",
                           precision="high_verified", verify_margin=HIGH_MARGIN)
        torch.cuda.synchronize()
        t_up = time.perf_counter() - t0
        sp = ver.space
        say(f"  (c) gist1m {N_GIST}x{D_GIST} f32 cosine: drawn in {t_gen:.1f} s, "
            f"file written in {t_build:.1f} s, Reader.open + upload {t_up:.2f} s "
            f"({sp.nbytes / 2**20:.0f} MiB on the card, padded_dim {sp.padded_dim})")

        def twin(p):
            return SearchEngine(DeviceSpace(
                sp.data, sp.norms, sp.num_valid, sp.dim, sp.metric, sp.valid_mask,
                sp.dtype, precision=p, host_ids=sp.host_ids))

        engines = {"highest": twin("highest"), "high": twin("high"),
                   "high_verified": ver}
        queries = {nq: g.standard_normal((nq, D_GIST)).astype(np.float32)
                   for nq in (64, 256)}
        sift = Reader.open(sift_path).vector_space("sift")
        sift_v = SearchEngine(sift, device="cuda", precision="high_verified",
                              verify_margin=HIGH_MARGIN)
        sift_h = SearchEngine(sift, device="cuda")
        q_sift = {nq: rng.integers(0, 256, (nq, D_MAIN)).astype(np.float32)
                  for nq in (32, 256)}

        # The main path, counted: high_verified searches at both cells.
        fused_topk.launches_high = 0
        fused_topk.launches = 0
        rescore_candidates.launches = 0
        res = {nq: ver.search(q, k=HIGH_K) for nq, q in queries.items()}
        res_sift = {nq: sift_v.search(q, k=HIGH_K) for nq, q in q_sift.items()}
        launches = fused_topk.launches_high
        rescores = rescore_candidates.launches
        fallbacks = fused_topk.launches
        if launches != len(res) + len(res_sift) or rescores != launches:
            raise AssertionError(
                f"high_verified launched the variant {launches} and K3 {rescores} "
                f"times for {len(res) + len(res_sift)} searches")
        say(f"  (c) main path: {len(res) + len(res_sift)} high_verified searches, "
            f"fused_topk[high] launches {launches}, rescore_candidates "
            f"{rescores}, highest re-runs {fallbacks}; verify_stats gist1m "
            f"{ver.verify_stats}, phase 3 corpus {sift_v.verify_stats}")
        for nq, r in res_sift.items():
            want = sift_h.search(q_sift[nq], k=HIGH_K)
            if not (np.array_equal(r.indices, want.indices)
                    and np.array_equal(r.scores, want.scores)):
                raise AssertionError(f"phase 3 corpus batch {nq}: high_verified "
                                     "differs from highest")
        say("  (c) phase 3 corpus (1M x 128 integer f32, L2) at high_verified: "
            "identical to highest at batches 32 and 256")

        x64 = sp.data.double()
        inv64 = 1.0 / torch.sqrt((x64 ** 2).sum(1))
        recall = {}
        for nq, q in queries.items():
            for p, e in engines.items():
                got = res[nq] if p == "high_verified" else e.search(q, k=HIGH_K)
                recall[(p, nq)] = _cosine_recall(torch, x64, inv64, q, got.indices, HIGH_K)
            say(f"  (c) gist1m batch={nq}: recall@10 " + ", ".join(
                f"{p} {recall[(p, nq)]:.4f}" for p in engines))
            if recall[("high_verified", nq)] != 1.0:
                raise AssertionError(f"gist1m high_verified recall@10 at batch {nq}")
        prep = sp.prepare_queries(queries[256])
        s_h, i_h = fused_topk(prep.qdev, sp.data, sp.norms, sp.num_valid,
                              HIGH_K + HIGH_MARGIN, cos, precision="high")
        ratio = _scan_ratio(torch, prep.qdev, sp.data, sp.norms, s_h, i_h, cos,
                            D_GIST)
        raw = float(ver._verify_eps(prep)[0]) / VERIFY_SAFETY
        s64 = ((x64[i_h.long()] * prep.qdev.double()[:, None, :]).sum(-1)
               * inv64[i_h.long()])
        err = float((s_h.double() - s64).abs().max())
        say(f"  (b) gist1m batch 256: max |high - f64| {err:.3g}, {err / raw:.4f} of "
            f"the certificate's raw bound {raw:.3g} (eps {2 * raw:.3g}); "
            f"{ratio:.4f} of the scan's own bound")
        if ratio >= 1.0:
            raise AssertionError("gist1m: the scan's error passed its bound")
        del x64, inv64, s64
        torch.cuda.empty_cache()

        cell, cell_err = _time_high_cell(
            torch, dev, card, engines, "gist1m", (64, 256), cos,
            lambda nq: g.standard_normal((nq, D_GIST)).astype(np.float32), False)
        max_err = max(max_err, cell_err)
        sift_engines = {"highest": sift_h, "high_verified": sift_v}
        _time_high_cell(torch, dev, card, sift_engines, "phase 3 corpus", (32, 256),
                        DistanceMetric.L2,
                        lambda nq: rng.integers(0, 256, (nq, D_MAIN)).astype(np.float32),
                        True)
        say(f"  (c) verify_stats after timing: gist1m {ver.verify_stats}, phase 3 "
            f"corpus {sift_v.verify_stats}")
    finally:
        tmp.cleanup()
    say(f"phase 13 precision ladder: ok (fused_topk[high] launches {launches}, "
        f"recall@10 high_verified 1.0000, high "
        f"{min(recall[('high', nq)] for nq in queries):.4f}; "
        f"{time.perf_counter() - t_phase:.1f} s)")
    top = cell[256]
    return {"launches": launches, "max_err": max_err, "ms": top["ms"],
            "plain_ms": top["plain_ms"], "bound": top["bound"],
            "keep": {"data": sp.data, "norms": sp.norms, "num_valid": sp.num_valid}}


# -- phase 14: quantized and bf16 spaces -------------------------------------

INT_SOURCE = CSRC + "topk_int_kernel.cu"
# The kernel this replaces, from PERF.md (NVIDIA H100 80GB HBM3, 700 W):
# the mma.sync integer scan, in ms.
MMA_SYNC_INT_MS = {("deep10m", 128): 7.4006, ("deep10m", 32): 2.8819,
               ("sift1m-u8", 256): 2.2363}
# Dense int8 tensor-core rate of the H100 SXM data sheet at 700 W.
INT8_OPS = 1979e12
# benchmarks/suite.py's deep10m (:412-445) and sift1m-u8 (:268-301).
N_DEEP, D_DEEP, DEEP_SEED, DEEP_SCALE, DEEP_BATCH = 10_000_000, 96, 4, 0.02, 128
U8_SEED, U8_BATCH = 2, 256
U8_COS_QUANT = (0.02, 3.0)  # (scale, zero_point) of the uint8 cosine space


def int_bound(nq: int, n: int, d: int, k: int, bias: bool = False) -> tuple[float, str]:
    """(bound_ms, bound_by) of the integer variant: 2 Q N D operations at
    the dense int8 rate, or its bytes (the D bytes of each row it reads,
    the norms, the row sums with ``bias`` and the int8 queries read once,
    the top k written once)."""
    t_ops = 2 * nq * n * d / INT8_OPS * 1e3
    t_bytes = (n * d + 4 * n * (1 + bias) + nq * d + 8 * nq * k) / HBM_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def _int_recall_on_card(torch, data, dim, qq, rows, k):
    """recall@k of an inner-product search against the float64 oracle of
    the int8 queries ``qq`` (on the card) over the int8 rows ``data[:, :dim]``
    (the engine's block), computed on the card a million rows at a time; a
    returned row is a hit when its exact dot reaches the k-th best."""
    q64 = qq[:, :dim].double()
    best = None
    for c0 in range(0, data.shape[0], 1_000_000):
        top = torch.topk(q64 @ data[c0 : c0 + 1_000_000, :dim].double().T, k, dim=1).values
        best = top if best is None else torch.topk(torch.cat([best, top], 1), k, dim=1).values
    r = torch.from_numpy(rows.astype(np.int64)).to(data.device)
    got = (data[r.clamp(min=0)][:, :, :dim].double() * q64[:, None, :]).sum(-1)
    return float(((got >= best[:, -1:]) & (r >= 0)).sum()) / rows.size


def _int_cases(torch, dev, rng) -> int:
    """(a) The integer variant on 200,003 int8 rows with twins across splits
    at D in {96, 100, 1536}: the three metrics, int8 with a scale (deferred
    for IP) and the uint8 offset form (recentred codes, their row sums as
    ``bias_row``, the scales of full-range integer queries), batches 1, 33
    and 255, k rotating through {10, 100, 257}, num_valid ending inside a
    split and a mask that empties whole splits; each case twice, identical
    to the plain version. Below D = 128 rows and queries are the first D
    columns of 128-byte rows whose other bytes are random, as the engine
    hands over its padded blocks. Returns the cases run."""
    from metrovector_tpu_torch import DistanceMetric
    from metrovector_tpu_torch.ops.topk_kernel import fused_topk, fused_topk_reference

    n, cases = SPLIT_N, 0
    mask = np.ones(n, np.float32)
    mask[40_000:120_000] = 0
    mask_d = torch.from_numpy(mask).to(dev)
    forms = {"int8": dict(scale=0.37),
             "uint8 offset": dict(scale=128 / 127, bias_scale=128.0)}
    for d in (96, 100, 1536):
        width = max(d, 128)
        base = rng.integers(-128, 128, (3000, width)).astype(np.int8)
        x = torch.from_numpy(base[rng.integers(0, 3000, n)]).to(dev)
        x[:, d:] = torch.randint(-128, 128, (n, width - d), device=dev).to(torch.int8)
        x = x[:, :d]
        bias = x.sum(1, dtype=torch.int32).float()
        norms = {"int8": ((x.double() * 0.37) ** 2).sum(1).float(),
                 "uint8 offset": ((x.double() + 128) ** 2).sum(1).float()}
        q_host = rng.integers(-128, 128, (255, width)).astype(np.int8)
        for nq in (1, 33, 255):
            q = torch.from_numpy(q_host[:nq]).to(dev)[:, :d]
            for metric in (DistanceMetric.L2, DistanceMetric.INNER_PRODUCT,
                           DistanceMetric.COSINE):
                for form, kw in forms.items():
                    kw = dict(kw, bias_row=bias if form != "int8" else None)
                    k = (10, 100, 257)[cases % 3]
                    variant = (cases + cases // 4) % 4
                    num_valid = n - 70_001 if variant & 1 else n
                    args = (q, x, norms[form], num_valid, k, metric,
                            mask_d if variant & 2 else None)
                    _twice_identical(
                        torch, lambda *a, kw=kw: fused_topk(*a, **kw), args,
                        fused_topk_reference(*args, **kw),
                        f"fused_topk[int8] {form} D={d} Q={nq} k={k} {metric.name} "
                        f"num_valid={num_valid} mask={bool(variant & 2)}")
                    cases += 1
        if d in TILE_EDGE_D:  # the wgmma tiles' edges, rows ending mid-stage
            m = TILE_EDGE_N
            q_edge = rng.integers(-128, 128, (max(TILE_EDGE_BATCHES), width)).astype(np.int8)
            for nq in TILE_EDGE_BATCHES:
                q = torch.from_numpy(q_edge[:nq]).to(dev)[:, :d]
                for metric in (DistanceMetric.L2, DistanceMetric.INNER_PRODUCT):
                    for form, kw in forms.items():
                        kw = dict(kw, bias_row=bias[:m] if form != "int8" else None)
                        k = (10, 100, 257)[cases % 3]
                        args = (q, x[:m], norms[form][:m], m - 29 if cases & 1 else m, k,
                                metric, mask_d[:m] if cases & 2 else None)
                        _twice_identical(
                            torch, lambda *a, kw=kw: fused_topk(*a, **kw), args,
                            fused_topk_reference(*args, **kw),
                            f"fused_topk[int8] tile edge {form} D={d} Q={nq} N={m} "
                            f"k={k} {metric.name}")
                        cases += 1
        del x, bias, norms
        torch.cuda.empty_cache()
    return cases


def _scan_smem_mirrors(torch) -> int:
    """The shared memory of the tensor-core scans' shapes that the wrapper
    plans (ops/topk_kernel.py::_int_shape, _high_shape, and
    ops/adc_kernel.py::int8_mma_shape, K2's int8-LUT product) against the
    library's own sizes: the kernels lay out what the plan counted. Returns
    the shapes checked."""
    from metrovector_tpu_torch.ops import _build
    from metrovector_tpu_torch.ops import adc_kernel as ak
    from metrovector_tpu_torch.ops import topk_kernel as tk

    lib, shapes = _build.load(), 0
    for nq in (1, 8, 33, 64, 128, 129, 256):
        for k in (1, 10, 18, 100, 128, 129, 257):
            for d in (96, 100, 128, 960, 1536):
                s = tk._int_shape(nq, d, k)
                got = lib.mvt_fused_topk_int_smem(s.nw, -(-d // tk.INT_CHUNK), s.stages,
                                                  int(s.resident), 0 if s.big else k)
                h = tk._high_shape(nq, k)
                got_h = lib.mvt_fused_topk_high_smem(h.nw, h.stages, 0 if h.big else k)
                if (got, got_h) != (s.smem, h.smem) or max(got, got_h) > tk.SMEM_LIMIT:
                    raise AssertionError(f"scan shared memory Q={nq} k={k} D={d}: "
                                         f"library {got}, {got_h}; plan {s.smem}, {h.smem}")
                shapes += 2
    for nq in (1, 32, 33, 64, 128, 129, 256, 4096):
        for k in (1, 10, 128, 129, 400, 1000, 1024):
            for m, cols in ((32, 16), (24, 12), (23, 12), (32, 32), (23, 23), (16, 8),
                            (64, 32), (200, 100), (270, 135), (199, 199)):
                p = ak.int8_mma_shape(nq, m, cols, k)
                got = lib.mvt_adc_int8_mma_smem(p.nw, m, cols, p.stages,
                                                0 if p.big else k)
                if got != p.smem or got > tk.SMEM_LIMIT:
                    raise AssertionError(f"int8 LUT product shared memory Q={nq} k={k} "
                                         f"m={m} cols={cols}: library {got}, plan {p.smem}")
                shapes += 1
    return shapes


def _affine_cases(torch, dev, rng) -> tuple[int, float]:
    """(a) The affine int8 load on 20,003 rows of random codes read as
    ``(c + 128 − zp)·scale``, D in {128, 100}, the three metrics, batches 1,
    33 and 255, k in {10, 257}: within phase 2's f32 band of the plain
    version (N(0, 1) queries, unit for cosine). Returns (cases, max |score
    diff|)."""
    from metrovector_tpu_torch import DistanceMetric
    from metrovector_tpu_torch.ops.topk_kernel import fused_topk, fused_topk_reference

    n, cases, err = 20_003, 0, 0.0
    scale, zp = U8_COS_QUANT
    affine = (128.0 - zp, scale)
    for d in (128, 100):
        codes = rng.integers(-128, 128, (n, d)).astype(np.int8)
        x = ((codes.astype(np.float32) + np.float32(affine[0]))
             * np.float32(affine[1]))
        norms = (x.astype(np.float64) ** 2).sum(1).astype(np.float32)
        db = torch.from_numpy(codes).to(dev)
        nd = torch.from_numpy(norms).to(dev)
        for metric in (DistanceMetric.L2, DistanceMetric.INNER_PRODUCT,
                       DistanceMetric.COSINE):
            q_all = rng.standard_normal((255, d)).astype(np.float32)
            if metric == DistanceMetric.COSINE:
                q_all /= np.linalg.norm(q_all, axis=1, keepdims=True)
            scores = _f64_scores(q_all, x, norms, metric)
            for nq in (1, 33, 255):
                q = np.ascontiguousarray(q_all[:nq])
                qd = torch.from_numpy(q).to(dev)
                for k in (10, 257):
                    got = fused_topk(qd, db, nd, n, k, metric, affine=affine)
                    ref = fused_topk_reference(qd, db, nd, n, k, metric, affine=affine)
                    if metric == DistanceMetric.COSINE:
                        tol = np.full(nq, 4 * d * 2.0**-24 + 2.0**-22)
                    else:
                        tol = (4 * d * 2.0**-24 * np.linalg.norm(q, axis=1)
                               * np.sqrt(norms.max()))
                    err = max(err, _compare(got, ref, False, tol, scores[:nq],
                                            f"fused_topk[affine] D={d} Q={nq} k={k} "
                                            f"{metric.name}"))
                    cases += 1
    return cases, err


def _lut8_case(torch, dev, rng, m, ksub, packed, n, nq, k, metric, masked,
               extreme=False, cut=None) -> None:
    """One int8-LUT case on ``n`` rows of codes with twins (3,000 distinct
    rows), twice identical to the plain version: ``masked`` a mask that
    empties rows n/5 to n/2, and num_valid ending 7,001 rows early (``cut``,
    default ``masked``, sets the latter apart). ``extreme``: every LUT
    entry ±127 (dsub = 1, codebook entries ±1, queries of ones), rows 0-49
    all code 0 (+127 in every subspace) and 50-99 all code 1 (-127), so
    |sum| = 127 m."""
    from metrovector_tpu_torch import DistanceMetric
    from metrovector_tpu_torch.index.pq import pack_codes4
    from metrovector_tpu_torch.ops.adc_kernel import (
        fused_adc_topk, fused_adc_topk_reference,
    )

    dsub = 1 if extreme else 4
    base = rng.integers(0, ksub, (3000, m)).astype(np.uint8)
    codes = base[rng.integers(0, 3000, n)]
    if extreme:
        books = np.where(rng.random((m, ksub, 1)) < 0.5, -1.0, 1.0).astype(np.float32)
        books[:, 0], books[:, 1] = 1.0, -1.0
        codes[:50], codes[50:100] = 0, 1
        q = np.ones((nq, m), np.float32)
    else:
        books = rng.standard_normal((m, ksub, dsub)).astype(np.float32)
        q = rng.standard_normal((nq, m * dsub)).astype(np.float32)
    if metric == DistanceMetric.COSINE:
        q /= np.linalg.norm(q, axis=1, keepdims=True)
    recon = np.concatenate([books[j][codes[:, j]] for j in range(m)], axis=1)
    rn = torch.from_numpy((recon.astype(np.float64) ** 2).sum(1).astype(np.float32)).to(dev)
    stored = torch.from_numpy(pack_codes4(codes) if packed else codes).to(dev)
    mask = None
    if masked:
        keep = np.ones(n, np.float32)
        keep[n // 5: n // 2] = 0
        mask = torch.from_numpy(keep).to(dev)
    num_valid = n - 7_001 if (masked if cut is None else cut) else n
    args = (torch.from_numpy(q).to(dev), stored, torch.from_numpy(books).to(dev), rn,
            num_valid, k, metric, mask, False, packed)
    _twice_identical(
        torch, lambda *a: fused_adc_topk(*a, int8_lut=True), args,
        fused_adc_topk_reference(*args, int8_lut=True),
        f"fused_adc_topk[int8_lut] m={m} ksub={ksub} packed={packed} N={n} Q={nq} "
        f"k={k} {metric.name} num_valid={num_valid} mask={bool(masked)} extreme={extreme}")


def _lut8_cases(torch, dev, rng) -> tuple[int, int]:
    """(a) The int8 LUT on both routes, each case twice identical to the
    plain version: on 200,003 rows of codes with twins across splits, pq4
    (m=32, ksub=16, packed: the tensor-core product) and pq8 (m=16,
    ksub=256: the lookup scan), N(0, 1) codebooks and queries, the three
    metrics, k in {1, 10, 400}, batches rotating through 1, 33 and 255,
    num_valid and the mask as in _int_cases; then on 100,037 rows (ending
    inside a 64-row stage) unpacked ksub=16 codes, ksub=8 (LUT columns
    padded to 16), odd m = 23 and deep100m-pq4's m = 24, the query tiles'
    edges (batches 128, 129 and 256), k = 1024 and, with the product's
    lists in device memory and the merge tree, k = 1025, packed and not;
    on 20,003 rows k = N, packed and not; the largest pq4 LUTs the product
    holds (m = 270 packed, 199 not) and the smallest it routes to the
    lookup scan (m = 288 packed, 200 not); and LUTs of ±127 alone (|sum| =
    127 m) at m=32 ksub=16, at the lookup lanes' bound (m = 256 and 257 at
    ksub = 256) and across a widening of packed lanes (m = 288 and 513 at
    ksub = 16, the lookup route). Returns (cases, of them the tensor-core
    product's launches / 2)."""
    from metrovector_tpu_torch import DistanceMetric
    from metrovector_tpu_torch.ops.adc_kernel import fused_adc_topk, int8_lut_route

    l2, ip, cos = (DistanceMetric.L2, DistanceMetric.INNER_PRODUCT,
                   DistanceMetric.COSINE)
    n, cases = SPLIT_N, 0
    mma0 = fused_adc_topk.int8_mma_launches
    for m, ksub, packed in ((32, 16, True), (16, 256, False)):
        for metric in (l2, ip, cos):
            for k in (1, 10, 400):
                nq = (1, 33, 255)[cases % 3]
                variant = (cases + cases // 4) % 4
                _lut8_case(torch, dev, rng, m, ksub, packed, n, nq, k, metric, variant & 2,
                           cut=variant & 1)
                cases += 1
    e, s = TILE_EDGE_N, 20_003
    edges = [  # (m, ksub, packed, n, nq, k, metric, masked)
        (32, 16, False, e, 128, 400, l2, True), (32, 16, False, e, 33, 10, cos, False),
        (16, 8, True, e, 129, 10, l2, False), (23, 8, False, e, 256, 400, ip, True),
        (23, 16, True, e, 129, 400, l2, True), (23, 16, False, e, 64, 100, cos, False),
        (24, 16, True, e, 256, 400, l2, False), (24, 16, True, e, 128, 10, ip, True),
        (32, 16, True, e, 129, 400, cos, True), (32, 16, True, e, 256, 1024, l2, True),
        (32, 16, True, e, 256, 10, ip, False), (16, 256, False, e, 256, 1024, l2, True),
        (16, 256, False, e, 129, 400, ip, False), (12, 256, False, e, 128, 10, cos, True),
        (32, 16, True, e, 33, 1025, l2, True), (32, 16, False, e, 129, 1025, ip, False),
        (32, 16, True, s, 9, s, l2, False), (24, 16, False, s, 37, s, cos, True),
        (270, 16, True, s, 65, 400, l2, True), (199, 16, False, s, 33, 10, ip, False),
        (288, 16, True, s, 65, 400, l2, True), (200, 16, False, s, 33, 10, ip, False),
    ]
    for m, ksub, packed, rows, nq, k, metric, masked in edges:
        cols = (m + 1) // 2 if packed else m
        want = "lookup" if ksub > 16 or m in (288, 200) else "mma"
        if int8_lut_route(ksub, m, cols) != want:
            raise AssertionError(f"int8 LUT m={m} ksub={ksub} packed={packed} does not "
                                 f"route to {want}")
        _lut8_case(torch, dev, rng, m, ksub, packed, rows, nq, k, metric, masked)
        cases += 1
    for m, ksub, packed in ((32, 16, False), (256, 256, False), (257, 256, False),
                            (288, 16, True), (513, 16, True)):
        for metric in (ip, l2):
            _lut8_case(torch, dev, rng, m, ksub, packed, 20_003, 9, 10, metric, False,
                       extreme=True)
            cases += 1
    return cases, (fused_adc_topk.int8_mma_launches - mma0) // 2


def _p50(torch, search, hosts, dev, **kw) -> float:
    """search() p50 in ms over the host query sets ``hosts``."""
    from metrovector_tpu_torch.utils.timing import sync_time

    search(hosts[0], **kw)
    return float(np.median([sync_time(search, h, device=dev, **kw)[0]
                            for h in hosts])) * 1e3


def _kernel_times(torch, dev, kern, plain, inputs, plain_inputs) -> tuple[float, list, float]:
    """(kernel ms, its two runs, plain ms) by CUDA events in the order
    plain, kernel, kernel, plain."""
    from metrovector_tpu_torch.utils.timing import cuda_ms

    kern(inputs[0])
    plain(plain_inputs[0])
    p1 = cuda_ms(plain, plain_inputs, dev)
    k1 = cuda_ms(kern, inputs, dev)
    k2 = cuda_ms(kern, inputs, dev)
    p2 = cuda_ms(plain, plain_inputs, dev)
    return (k1 + k2) / 2, [k1, k2], (p1 + p2) / 2


def _deep10m(torch, dev, card, tmpdir) -> dict:
    """(b) deep10m at full size through the public path (module
    docstring). Returns the kernels-line figures of fused_topk[int8]."""
    from metrovector_tpu_torch import Builder, DataType, DistanceMetric, Reader, SearchEngine
    from metrovector_tpu_torch.ops.topk_kernel import fused_topk, fused_topk_reference

    ip = DistanceMetric.INNER_PRODUCT
    rng = np.random.default_rng(DEEP_SEED)
    t0 = time.perf_counter()
    codes = rng.integers(-128, 128, (N_DEEP, D_DEEP)).astype(np.int8)
    t_gen = time.perf_counter() - t0
    path = os.path.join(tmpdir, "deep10m.mvt")
    t0 = time.perf_counter()
    b = Builder()
    b.add_vector_space("deep", dim=D_DEEP, dtype=DataType.INT8,
                       metric=ip).with_quantization(DEEP_SCALE, 0.0)
    for c0 in range(0, N_DEEP, 1_000_000):
        b.add_vectors("deep", codes[c0 : c0 + 1_000_000])
    b.build().save(path)
    _keep_for_p17("deep10m", path)
    del b, codes
    t_build = time.perf_counter() - t0
    t0 = time.perf_counter()
    engine = SearchEngine(Reader.open(path).vector_space("deep"), device="cuda")
    torch.cuda.synchronize()
    t_up = time.perf_counter() - t0
    sp = engine.space
    say(f"  (b) deep10m {N_DEEP}x{D_DEEP} int8 IP, scale {DEEP_SCALE} (seed {DEEP_SEED}): "
        f"drawn in {t_gen:.1f} s, file written in {t_build:.1f} s (Builder in "
        f"chunks of 1M rows), Reader.open + upload {t_up:.2f} s ({sp.nbytes / 2**20:.0f} "
        f"MiB on the card, padded_dim {sp.padded_dim})")
    batches = (DEEP_BATCH, 32)
    hosts = {nq: [rng.integers(-128, 128, (nq, D_DEEP)).astype(np.float32)
                  for _ in range(10)] for nq in batches}

    # The main path, counted: one search at each batch.
    fused_topk.launches_int = fused_topk.launches = fused_topk.launches_affine = 0
    res = {nq: engine.search(hosts[nq][0], k=10) for nq in batches}
    launches = fused_topk.launches_int
    if launches != len(batches) or fused_topk.launches or fused_topk.launches_affine:
        raise AssertionError(f"deep10m: {len(batches)} searches launched the integer "
                             f"variant {launches} times")
    recall = {}
    for nq in batches:
        prep = sp.prepare_queries(hosts[nq][0])
        recall[nq] = _int_recall_on_card(torch, sp.data, D_DEEP, prep.qdev,
                                         res[nq].indices, 10)
        if recall[nq] != 1.0:
            raise AssertionError(f"deep10m recall@10 {recall[nq]} at batch {nq}")
    say(f"  (b) deep10m recall@10 against the float64 oracle of the quantized "
        f"queries: " + ", ".join(f"batch {nq} {r:.4f}" for nq, r in recall.items())
        + f"; fused_topk[int8] launches {launches}")

    out = {}
    rows = sp.data[:, :D_DEEP]  # what SearchEngine hands the variant
    keep = {"rows": rows, "norms": sp.norms, "num_valid": sp.num_valid}
    for nq in batches:
        preps = [sp.prepare_queries(h) for h in hosts[nq]]
        qs = [p.qdev[:, :D_DEEP] for p in preps]
        scale = preps[0].dot_scale  # max|q| = 128 in every set: one scale

        def kern(q):
            return fused_topk(q, rows, sp.norms, sp.num_valid, 10, ip, scale=scale)

        def plain(q):
            return fused_topk_reference(q, rows, sp.norms, sp.num_valid, 10, ip,
                                        scale=scale)

        if any(p.dot_scale != scale for p in preps):
            raise AssertionError("deep10m query sets of differing scales")
        if nq == DEEP_BATCH:
            keep.update(queries=qs, scale=scale)
        _identical(torch, kern(qs[0]), plain(qs[0]), f"deep10m batch {nq}")
        kms, runs, pms = _kernel_times(torch, dev, kern, plain, qs, qs[:2])
        qt = [p.qdev.T.contiguous() if nq > 16 else None for p in preps]
        mm = None
        if nq > 16:  # torch._int_mm takes more than 16 rows a side
            torch._int_mm(sp.data, qt[0])
            from metrovector_tpu_torch.utils.timing import cuda_ms

            mm = cuda_ms(lambda b: torch._int_mm(sp.data, b), qt[:3], dev)
        p50 = _p50(torch, engine.search, hosts[nq], dev, k=10)
        bnd = int_bound(nq, sp.padded_rows, D_DEEP, 10)
        padded = int_bound(nq, sp.padded_rows, sp.padded_dim, 10)
        out[nq] = {"ms": kms, "plain_ms": pms, "bound": bnd, "p50": p50, "mm": mm}
        say(f"  (f) deep10m batch={nq}: fused_topk[int8] k=10 {kms:.4f} ms (runs "
            f"{runs[0]:.4f}, {runs[1]:.4f}; bound {bnd[0]:.4f} ms by {bnd[1]} at D="
            f"{D_DEEP}, {bnd[0] / kms:.1%}; at the padded D={sp.padded_dim} "
            f"{padded[0]:.4f}, {padded[0] / kms:.1%}) | plain {pms:.4f} | yardstick "
            f"torch._int_mm "
            f"[{sp.padded_rows},{sp.padded_dim}] x [{sp.padded_dim},{nq}] "
            + (f"{mm:.4f}" if mm is not None else "n/a")
            + f" | the mma.sync kernel it replaces {MMA_SYNC_INT_MS[('deep10m', nq)]:.4f} "
            f"(PERF.md) | search() p50 {p50:.4f} ms ({nq / p50 * 1e3:.0f} QPS) | {card}")
        del qs, qt
    del sp
    torch.cuda.empty_cache()
    return {"launches": launches, "cell": out, "recall": recall, "keep": keep,
            "engine": engine}  # the engine stays for phase 16


def _sift1m_u8(torch, dev, card, tmpdir) -> dict:
    """(c) sift1m-u8 at full size (module docstring), and a uint8 cosine
    space of the same codes. Returns the figures of fused_topk[int8] at
    batch 256 and of fused_topk[affine]."""
    from metrovector_tpu_torch import Builder, DataType, DistanceMetric, Reader, SearchEngine
    from metrovector_tpu_torch.ops.topk_kernel import fused_topk, fused_topk_reference

    l2, cos = DistanceMetric.L2, DistanceMetric.COSINE
    rng = np.random.default_rng(U8_SEED)
    u8 = rng.integers(0, 256, (N_MAIN, D_MAIN)).astype(np.uint8)
    path = os.path.join(tmpdir, "sift1m_u8.mvt")
    t0 = time.perf_counter()
    b = Builder()
    b.add_vector_space("u8", dim=D_MAIN, dtype=DataType.UINT8,
                       metric=l2).with_quantization(1.0, 0.0)
    b.add_vectors("u8", u8)
    b.add_vector_space("u8cos", dim=D_MAIN, dtype=DataType.UINT8,
                       metric=cos).with_quantization(*U8_COS_QUANT)
    b.add_vectors("u8cos", u8)
    b.build().save(path)
    _keep_for_p17("sift1m_u8", path)
    del b
    t_build = time.perf_counter() - t0
    t0 = time.perf_counter()
    reader = Reader.open(path)
    engine = SearchEngine(reader.vector_space("u8"), device="cuda")
    cos_engine = SearchEngine(reader.vector_space("u8cos"), device="cuda")
    torch.cuda.synchronize()
    t_up = time.perf_counter() - t0
    sp, sc = engine.space, cos_engine.space
    say(f"  (c) sift1m-u8 {N_MAIN}x{D_MAIN} uint8 L2 (seed {U8_SEED}) and the same "
        f"codes as a uint8 cosine space (scale {U8_COS_QUANT[0]}, zero_point "
        f"{U8_COS_QUANT[1]}): file written in {t_build:.1f} s, Reader.open + two "
        f"uploads {t_up:.2f} s ({(sp.nbytes + sc.nbytes) / 2**20:.0f} MiB on the card)")
    hosts = [rng.integers(0, 256, (U8_BATCH, D_MAIN)).astype(np.float32)
             for _ in range(10)]

    # The main path, counted: one search in each space.
    fused_topk.launches_int = fused_topk.launches = fused_topk.launches_affine = 0
    res = engine.search(hosts[0], k=10)
    res_c = cos_engine.search(hosts[0], k=10)
    launches = (fused_topk.launches_int, fused_topk.launches_affine)
    if launches != (1, 1) or fused_topk.launches:
        raise AssertionError(f"sift1m-u8: launches (int8, affine) {launches}, "
                             f"float {fused_topk.launches}")

    prep = sp.prepare_queries(hosts[0])
    s_r, i_r = fused_topk_reference(prep.qdev, sp.data, sp.norms, sp.num_valid, 10,
                                    l2, scale=prep.dot_scale, bias_row=sp.rowsums,
                                    bias_scale=prep.bias_scale)
    s_r = s_r.cpu().numpy() + 2.0 * prep.const[:, None]
    if not (np.array_equal(res.indices, i_r.cpu().numpy())
            and np.array_equal(res.scores, s_r)):
        raise AssertionError("sift1m-u8: search() differs from the plain version")
    x64 = torch.from_numpy(u8).to(dev, torch.float64)
    norms64 = (x64 * x64).sum(1)
    # the queries as the engine quantized them: o_q + s_q q' (scale 1)
    q_eff = (prep.qdev[:, :D_MAIN].double() * prep.dot_scale
             + prep.bias_scale).cpu().numpy()
    rec_q = _recall_on_card(torch, x64, norms64, q_eff, res.indices, 10)
    rec_raw = _recall_on_card(torch, x64, norms64, hosts[0], res.indices, 10)
    say(f"  (c) sift1m-u8 batch={U8_BATCH}: identical to the plain version; recall@10 "
        f"{rec_q:.4f} against the float64 oracle of the queries as quantized "
        f"(s_q = {prep.dot_scale:.6f}, o_q = {prep.bias_scale:.0f}), {rec_raw:.4f} "
        f"against that of the raw queries")

    # uint8 cosine: the affine load against its plain version, within the band
    scale, zp = U8_COS_QUANT
    affine = (128.0 - zp, scale)
    prep_c = sc.prepare_queries(hosts[0])
    ref_c = fused_topk_reference(prep_c.qdev, sc.data, sc.norms, sc.num_valid, 10,
                                 cos, affine=affine)
    xd = (x64 - zp) * scale
    inv64 = 1.0 / torch.sqrt((xd * xd).sum(1))
    got_c = (torch.from_numpy(res_c.scores).to(dev), torch.from_numpy(res_c.indices).to(dev))
    tol = np.full(U8_BATCH, 4 * D_MAIN * 2.0**-24 + 2.0**-22)
    odd = not np.array_equal(res_c.indices, ref_c[1].cpu().numpy())
    scores64 = None
    if odd:  # the exact scores decide whether a differing row is a near-tie
        q64 = prep_c.qdev.double()
        scores64 = ((q64 @ xd.T) * inv64[None, :]).cpu().numpy()
    aff_err = _compare(got_c, ref_c, False, tol, scores64, "uint8 cosine search()")
    rec_c = _cosine_recall(torch, xd, inv64, hosts[0], res_c.indices, 10)
    say(f"  (c) uint8 cosine batch={U8_BATCH}: within the f32 band of the plain version "
        f"(max |score diff| {aff_err:.3g}, indices identical: {not odd}); recall@10 "
        f"{rec_c:.4f} against the float64 oracle of the dequantized rows")
    del x64, norms64, xd, inv64

    preps = [sp.prepare_queries(h) for h in hosts]
    preps_c = [sc.prepare_queries(h) for h in hosts]

    def kern(p):
        return fused_topk(p.qdev, sp.data, sp.norms, sp.num_valid, 10, l2,
                          scale=p.dot_scale, bias_row=sp.rowsums, bias_scale=p.bias_scale)

    def plain(p):
        return fused_topk_reference(p.qdev, sp.data, sp.norms, sp.num_valid, 10, l2,
                                    scale=p.dot_scale, bias_row=sp.rowsums,
                                    bias_scale=p.bias_scale)

    def kern_c(q):
        return fused_topk(q, sc.data, sc.norms, sc.num_valid, 10, cos, affine=affine)

    def plain_c(q):
        return fused_topk_reference(q, sc.data, sc.norms, sc.num_valid, 10, cos,
                                    affine=affine)

    kms, runs, pms = _kernel_times(torch, dev, kern, plain, preps, preps[:3])
    qc = [p.qdev for p in preps_c]
    ams, aruns, apms = _kernel_times(torch, dev, kern_c, plain_c, qc, qc[:3])
    p50 = _p50(torch, engine.search, hosts, dev, k=10)
    p50_c = _p50(torch, cos_engine.search, hosts, dev, k=10)
    bnd = int_bound(U8_BATCH, sp.padded_rows, sp.padded_dim, 10, bias=True)
    n, d = sc.padded_rows, sc.padded_dim
    abnd = bound(2 * U8_BATCH * n * d, n * d + 4 * n + 4 * U8_BATCH * d + 8 * U8_BATCH * 10)
    say(f"  (f) sift1m-u8 batch={U8_BATCH}: fused_topk[int8] k=10 {kms:.4f} ms (runs "
        f"{runs[0]:.4f}, {runs[1]:.4f}; bound {bnd[0]:.4f} ms by {bnd[1]}, "
        f"{bnd[0] / kms:.1%}) | plain {pms:.4f} | the mma.sync kernel it replaces "
        f"{MMA_SYNC_INT_MS[('sift1m-u8', U8_BATCH)]:.4f} (PERF.md) | search() p50 "
        f"{p50:.4f} ms ({U8_BATCH / p50 * 1e3:.0f} QPS) | {card}")
    say(f"  (f) uint8 cosine batch={U8_BATCH}: fused_topk[affine] k=10 {ams:.4f} ms "
        f"(runs {aruns[0]:.4f}, {aruns[1]:.4f}; bound {abnd[0]:.4f} ms by {abnd[1]}, "
        f"{abnd[0] / ams:.1%}) | plain {apms:.4f} | search() p50 {p50_c:.4f} ms "
        f"({U8_BATCH / p50_c * 1e3:.0f} QPS) | {card}")
    engines = {"u8": engine, "u8cos": cos_engine}  # for phase 16
    del engine, cos_engine, sp, sc, preps, preps_c, qc
    torch.cuda.empty_cache()
    return {"engines": engines,
            "int8": {"launches": launches[0], "ms": kms, "plain_ms": pms, "bound": bnd,
                     "p50": p50, "recall": (rec_q, rec_raw)},
            "affine": {"launches": launches[1], "ms": ams, "plain_ms": apms,
                       "bound": abnd, "p50": p50_c, "err": aff_err, "recall": rec_c}}


def lut8_bounds(nq: int, n: int, m: int, ksub: int, cols: int, k: int) -> dict:
    """Both bounds of an int8-LUT scan over ``n`` rows of ``cols`` code
    bytes, each (bound_ms, bound_by) with the bytes of the codes, norms, LUT
    and scales read once and the top k written once: the lookups' adds on
    the CUDA cores (2 Q N m at 67 T/s, an add counting two, as K2's f32
    bound) and the one-hot product on the tensor cores (2 Q N K at the
    dense int8 rate, K = 16 m at ksub <= 16, m ksub above). The share is
    taken from the lesser."""
    nbytes = n * cols + 4 * n + nq * m * ksub + 4 * nq + 8 * nq * k
    t_bytes = nbytes / HBM_BYTES * 1e3
    cores = bound(2 * nq * n * m, nbytes)
    t_mma = 2 * nq * n * m * max(ksub, 16) / INT8_OPS * 1e3
    tensor = (t_mma, "operations") if t_mma >= t_bytes else (t_bytes, "bytes")
    return {"cuda_cores": cores, "tensor_cores": tensor, "least": min(cores, tensor)}


def _bf16_storage(torch, dev, card, sift_path, tmpdir) -> dict:
    """(e) Phase 3's corpus written as BFLOAT16 (its integer values are
    exact in bf16): search() identical to the f32 space at batches 32 and
    256; K1 over the bf16 rows timed beside the f32 rows."""
    from metrovector_tpu_torch import Builder, DataType, DistanceMetric, Reader, SearchEngine
    from metrovector_tpu_torch.ops.topk_kernel import fused_topk

    l2 = DistanceMetric.L2
    sift = Reader.open(sift_path).vector_space("sift")
    path = os.path.join(tmpdir, "sift1m_bf16.mvt")
    t0 = time.perf_counter()
    b = Builder()
    b.add_vector_space("sift", dim=D_MAIN, dtype=DataType.BFLOAT16, metric=l2)
    b.add_vectors("sift", sift.to_numpy())
    b.build().save(path)
    del b
    t_build = time.perf_counter() - t0
    bf = SearchEngine(Reader.open(path).vector_space("sift"), device="cuda")
    f32 = SearchEngine(sift, device="cuda")
    rng = np.random.default_rng(SEED + 15)
    hosts = {nq: [rng.integers(0, 256, (nq, D_MAIN)).astype(np.float32)
                  for _ in range(10)] for nq in (32, 256)}
    fused_topk.launches = 0
    res = {nq: bf.search(h[0], k=10) for nq, h in hosts.items()}
    if fused_topk.launches != len(res) or bf.space.data.dtype != torch.bfloat16:
        raise AssertionError("the bf16 space did not run K1 over bf16 rows")
    for nq, r in res.items():
        want = f32.search(hosts[nq][0], k=10)
        if not (np.array_equal(r.indices, want.indices)
                and np.array_equal(r.scores, want.scores)
                and np.array_equal(r.distances, want.distances)):
            raise AssertionError(f"bf16 space differs from the f32 space at batch {nq}")
    from metrovector_tpu_torch.utils.timing import cuda_ms

    times = {}
    for nq in (32, 256):
        qs = [torch.from_numpy(h).to(dev) for h in hosts[nq]]
        ms = {}
        for name, e in (("bf16", bf), ("f32", f32)):
            s = e.space

            def kern(q, s=s):
                return fused_topk(q, s.data, s.norms, s.num_valid, 10, l2)

            kern(qs[0])
            ms[name] = cuda_ms(kern, qs, dev)
        ms["p50"] = _p50(torch, bf.search, hosts[nq], dev, k=10)
        times[nq] = ms
        say(f"  (f) bf16 storage batch={nq}: K1 over bf16 rows {ms['bf16']:.4f} ms, "
            f"over f32 rows {ms['f32']:.4f} ms | search() p50 {ms['p50']:.4f} ms | {card}")
    say(f"  (e) phase 3 corpus as BFLOAT16 (file written in {t_build:.1f} s, "
        f"{bf.space.nbytes / 2**20:.0f} MiB on the card): identical to the f32 space "
        f"at batches 32 and 256")
    del bf, f32
    torch.cuda.empty_cache()
    return times


def phase_quantized(torch, dev, card, sift_path, pq4) -> dict:
    """Phase 14 (module docstring). Returns the kernels-line figures of
    fused_topk[int8], fused_topk[affine] and fused_adc_topk[int8_lut]."""
    t_phase = time.perf_counter()
    rng = np.random.default_rng(SEED + 14)
    t0 = time.perf_counter()
    int_cases = _int_cases(torch, dev, rng)
    mirrors = _scan_smem_mirrors(torch)
    aff_cases, aff_err = _affine_cases(torch, dev, rng)
    lut_cases, mma_cases = _lut8_cases(torch, dev, rng)
    say(f"  (a) kernels vs plain: fused_topk[int8] {int_cases} cases identical twice "
        f"(tile edges: batches {TILE_EDGE_BATCHES}, {TILE_EDGE_N} rows; scan shared "
        f"memory as planned at {mirrors} shapes); "
        f"fused_topk[affine] {aff_cases} cases within the f32 band (max |score diff| "
        f"{aff_err:.3g}); fused_adc_topk int8 LUT {lut_cases} cases identical twice "
        f"({mma_cases} by the tensor-core product, {lut_cases - mma_cases} by lookups) "
        f"({time.perf_counter() - t0:.1f} s)")
    tmp = tempfile.TemporaryDirectory()
    try:
        deep = _deep10m(torch, dev, card, tmp.name)
        u8 = _sift1m_u8(torch, dev, card, tmp.name)
        lut = _int8_lut_searches(torch, dev, card, "(d) sift1m-pq4", "mma", *pq4)
        _bf16_storage(torch, dev, card, sift_path, tmp.name)
    finally:
        tmp.cleanup()
    say(f"phase 14 quantized and bf16 spaces: ok (deep10m recall@10 1.0000, "
        f"sift1m-u8 identical to plain, pq4 int8 LUT recall@10 "
        f"{min(lut['recall'].values()):.4f}, bf16 identical to f32; launches "
        f"fused_topk[int8] {deep['launches'] + u8['int8']['launches']}, "
        f"fused_topk[affine] {u8['affine']['launches']}, fused_adc_topk[int8_mma] "
        f"{lut['launches']}; {time.perf_counter() - t_phase:.1f} s)")
    top = deep["cell"][DEEP_BATCH]
    lut_top = lut["cell"][256]
    return {
        "int8": {"launches": deep["launches"] + u8["int8"]["launches"], "max_err": 0.0,
                 "ms": top["ms"], "plain_ms": top["plain_ms"], "bound": top["bound"]},
        "affine": {"launches": u8["affine"]["launches"],
                   "max_err": max(aff_err, u8["affine"]["err"]),
                   "ms": u8["affine"]["ms"], "plain_ms": u8["affine"]["plain_ms"],
                   "bound": u8["affine"]["bound"]},
        "int8_mma": {"launches": lut["launches"], "max_err": 0.0, "ms": lut_top["ms"],
                     "plain_ms": lut_top["plain_ms"], "bound": lut_top["bound"]},
        "keep": deep["keep"],
        "keep16": {"deep": deep["engine"], **u8["engines"]},
    }


def lookup_figures(torch, lookups: int, card: str) -> None:
    """K2's shared-memory lookups at the timed point (sift1m-pq4, batch
    256), one wavefront (128 bytes) a clock an SM at the 1,980 MHz boost
    clock: at 4 bytes a query-lookup, one wavefront per 32; in the
    query-interleaved 8-byte entries of adc_scan.cuh, a warp's load takes
    two wavefronts (measured on an H100, PERF.md) and serves 64
    query-lookups of an f32 LUT (2 queries an entry), 128 of a bf16 one."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    per_ms = sms * 1.98e9 / 1e3  # wavefronts a millisecond
    say(f"  K2 lookups at sift1m-pq4 batch 256: {lookups} query-lookups; at 4 B "
        f"each (one wavefront per 32) {lookups / 32 / per_ms:.4f} ms; in 8-byte "
        f"entries (2 wavefronts a load) f32 LUT {lookups / 32 / per_ms:.4f} ms, "
        f"bf16 LUT {lookups / 64 / per_ms:.4f} ms | {card}")


# -- phase 15: presampled and group_rows -------------------------------------

PRE_STRIDE = 64  # the reference's default stride, the timed one
PRE_STRIDES = (16, 64, 1000)
PRE_KS = (1, 10, 100, 257, 1000, 1025)


def _presampled_routes(torch, dev, rng, n, d):
    """The K1 routes of the exactness cases over 200,003 rows with twins
    across splits: (name, queries, db, norms, metric, kwargs) for FFMA
    f32/f16/bf16, "high", int8 IP with a deferred scale and int8 L2."""
    from metrovector_tpu_torch import DistanceMetric

    L2, IP = DistanceMetric.L2, DistanceMetric.INNER_PRODUCT
    x = torch.from_numpy(_twin_rows(rng, n, d, 16)).to(dev)
    norms = (x.double() ** 2).sum(1).float()
    q = torch.from_numpy(rng.integers(0, 16, (255, d)).astype(np.float32)).to(dev)
    c8 = torch.from_numpy(_twin_rows(rng, n, d, 16) - 8).to(dev).to(torch.int8)
    n8 = (c8.double() ** 2).sum(1).float()
    q8 = torch.from_numpy(rng.integers(-8, 8, (255, d)).astype(np.int8)).to(dev)
    return [("f32", q, x, norms, L2, {}),
            ("f16", q, x.to(torch.float16), norms, IP, {}),
            ("bf16", q, x.to(torch.bfloat16), norms, L2, {}),
            ("high", q, x, norms, IP, {"precision": "high"}),
            ("int8 IP deferred", q8, c8, n8, IP, {"scale": 0.02}),
            ("int8 L2", q8, c8, n8, L2, {})]


def _presampled_cases(torch, dev, rng) -> int:
    """fused_topk_presampled on every K1 route, strides 16, 64 and 1000, k
    in {1, 10, 100, 257, 1000, 1025}, batches 1, 33 and 255 by turns, with
    num_valid ending inside a split off the stride, a mask that kills every
    subsampled row (seed empty: floor 0), k above the subsample's live
    rows (stride 1000: 201 rows), and twins whose scan rows tie seeded
    scores at lower indices: twice identical, scores and indices, to
    fused_topk, to fused_topk_reference and to its plain version. Returns
    the cases run."""
    from metrovector_tpu_torch.ops.topk_kernel import (
        fused_topk, fused_topk_presampled, fused_topk_presampled_reference,
        fused_topk_reference,
    )

    n, cases = SPLIT_N, 0
    routes = _presampled_routes(torch, dev, rng, n, 128)
    for name, q_all, db, norms, metric, kw in routes:
        for stride in PRE_STRIDES:
            kill = torch.ones(n, device=dev)
            kill[::stride] = 0  # every subsampled row dead
            for k in PRE_KS:
                nq = (1, 33, 255)[cases % 3]
                variant = cases % 4
                num_valid = n - 70_001 if variant & 1 else n
                mask = kill if variant == 2 else None
                q = q_all[:nq]
                args = (q, db, norms, num_valid, k, metric)
                what = (f"presampled {name} {metric.name} stride={stride} Q={nq} k={k} "
                        f"num_valid={num_valid} mask={'kills the subsample' if mask is not None else None}")
                pkw = dict(kw, valid_mask=mask, stride=stride)
                fkw = dict(kw, valid_mask=mask)
                plain = fused_topk(*args, **fkw)
                _identical(torch, plain, fused_topk_reference(*args, **fkw), what + " (K1)")
                _identical(torch, fused_topk_presampled_reference(*args, **pkw), plain,
                           what + " (plain version)")
                _twice_identical(torch, lambda: fused_topk_presampled(*args, **pkw), (),
                                 plain, what)
                cases += 1
    del routes
    torch.cuda.empty_cache()
    return cases


def _held_to_plain(torch, got, ref, q, db, norms, metric, kw, what) -> float:
    """fused_topk_presampled (got) against its plain version (ref):
    identical, except on the float data of precision "high" (gist1m), where
    the plain version's f32 matmuls sum the same products in another order:
    there within phase 13's band (_compare_high). Returns the largest score
    difference."""
    if kw.get("precision") != "high":
        _identical(torch, got, ref, what)
        return 0.0
    return _compare_high(got, ref, _acc_band(q.cpu().numpy(), float(norms.max().sqrt()),
                                             metric, db.shape[1]),
                         _bf16x3_scores64(torch, q, db, norms, metric), what)


def _presampled_times(torch, dev, label, q_sets, db, norms, nv, k, metric, kw,
                      k1_bound, card) -> dict:
    """Phase 1, phase 2 and the whole of fused_topk_presampled (stride 64,
    the subsample pre-sliced) beside plain fused_topk, by CUDA events in
    one run, plain, presampled, presampled, plain, then its plain version
    on the first three of the same query sets; the seeded pair held
    identical to fused_topk, and to the plain version (_held_to_plain), on
    the first set. The
    bound is K1's (``k1_bound``): the function returns fused_topk's answer,
    and phase 1 is this algorithm's cost, not work that answer needs.
    Returns the row."""
    from metrovector_tpu_torch.ops.topk_kernel import (
        fused_topk, fused_topk_presampled, fused_topk_presampled_reference,
    )
    from metrovector_tpu_torch.utils.timing import cuda_ms

    s = PRE_STRIDE
    n = db.shape[0]
    t_copy = None
    if q_sets[0].dtype != torch.int8 and kw.get("precision") != "high":
        db[::s].contiguous()
        t_copy = cuda_ms(lambda _: db[::s].contiguous(), range(5), dev)
        db_sub = db[::s].contiguous()
    else:
        db_sub = db[::s]
    sub = (db_sub, norms[::s].contiguous())
    nv_sub, k1 = -(-nv // s), min(k, -(-n // s))
    seeds = [fused_topk(q, *sub, nv_sub, k1, metric, raw_scores=True, **kw) for q in q_sets]
    pairs = [(q, a, torch.where(b >= 0, b * s, b)) for q, (a, b) in zip(q_sets, seeds)]
    pre = lambda q: fused_topk_presampled(q, db, norms, nv, k, metric, stride=s, sub=sub, **kw)  # noqa: E731
    plain = lambda q: fused_topk(q, db, norms, nv, k, metric, **kw)  # noqa: E731
    p1 = lambda q: fused_topk(q, *sub, nv_sub, k1, metric, raw_scores=True, **kw)  # noqa: E731
    p2 = lambda t: fused_topk(t[0], db, norms, nv, k, metric, seed_s=t[1], seed_i=t[2],  # noqa: E731
                              exclude_stride=s, **kw)
    pv = lambda q: fused_topk_presampled_reference(  # noqa: E731
        q, db, norms, nv, k, metric, stride=s, sub=sub, **kw)
    _identical(torch, pre(q_sets[0]), plain(q_sets[0]), f"{label} k={k}: timed inputs")
    err = _held_to_plain(torch, pre(q_sets[0]), pv(q_sets[0]), q_sets[0], db, norms,
                         metric, kw, f"{label} k={k}: timed inputs vs the plain version")
    for fn, x in ((pre, q_sets[0]), (plain, q_sets[0]), (p1, q_sets[0]), (p2, pairs[0])):
        fn(x)
    a1 = cuda_ms(plain, q_sets, dev)
    b1 = cuda_ms(pre, q_sets, dev)
    t1 = cuda_ms(p1, q_sets, dev)
    t2 = cuda_ms(p2, pairs, dev)
    b2 = cuda_ms(pre, q_sets, dev)
    a2 = cuda_ms(plain, q_sets, dev)
    tv = cuda_ms(pv, q_sets[:3], dev)
    row = {"plain": (a1 + a2) / 2, "pre": (b1 + b2) / 2, "p1": t1, "p2": t2,
           "runs": (a1, b1, b2, a2), "copy": t_copy, "plain_version": tv, "err": err,
           "bound": k1_bound}
    say(f"  timing {label} k={k} stride {s}: presampled {row['pre']:.4f} ms "
        f"(runs {b1:.4f}, {b2:.4f}; phase 1 {t1:.4f} + phase 2 {t2:.4f} = {t1 + t2:.4f}) "
        f"| plain fused_topk {row['plain']:.4f} (runs {a1:.4f}, {a2:.4f}) | "
        f"presampled / plain {row['pre'] / row['plain']:.3f} | its plain version "
        f"fused_topk_presampled_reference {tv:.4f} | bound (K1's) {k1_bound[0]:.4f} ms "
        f"({k1_bound[1]}), share {k1_bound[0] / row['pre']:.1%}"
        + (f" | the subsample's copy db[::{s}].contiguous() {t_copy:.4f} ms" if t_copy else "")
        + f" | {card}")
    return row


def _group_rows_on_card(torch, dev, card, ivf) -> dict:
    """sift1m-ivfpq's rows bucket-major, padded to group_rows (phase 12's
    bucket layout as it stands: [C', B] slots, B = group_rows, dead slots
    masked): fused_adc_topk(group_rows=B) at the main path's inputs
    (batches 1, 8, 256, fetch 400, the search's bf16 LUT) identical to the
    group_ids form, to its plain version, and in its scores to the
    row-order call; a ragged N with a tail bucket longer than B, twice
    identical to both; then its device time. Returns the kernels-line
    row."""
    from metrovector_tpu_torch import DistanceMetric
    from metrovector_tpu_torch.ops.adc_kernel import fused_adc_topk, fused_adc_topk_reference
    from metrovector_tpu_torch.utils.timing import cuda_ms, device_ms

    L2 = DistanceMetric.L2
    idx = ivf["idx"]
    groups, width, cols = idx.buckets.shape
    codes = idx.buckets.reshape(-1, cols)
    norms = idx.bucket_norms.reshape(-1)
    ids = idx.bucket_ids.reshape(-1)
    live = (ids >= 0).float()
    n = codes.shape[0]
    gids = (torch.arange(n, device=dev) // width).to(torch.int32)
    m, ksub = idx._books.shape[:2]
    fill = idx.bucket_fill.double()
    # The main path, counted: one call at each batch's first inputs.
    fused_adc_topk.group_rows_launches = 0
    mains = {bsz: fused_adc_topk(p[0][0], codes, idx._books, norms, n, 400, L2, live,
                                 False, False, p[0][1], group_rows=width)
             for bsz, p in ivf["pins"].items()}
    launches = fused_adc_topk.group_rows_launches
    if launches != len(mains):
        raise AssertionError(f"{len(mains)} group_rows calls made {launches} launches")
    cell = {}
    for bsz, pins in ivf["pins"].items():
        qd, bias = pins[0]
        if bias.shape[1] != groups:
            raise AssertionError("sift1m-ivfpq: a bias column per bucket of the layout")
        args = (codes, idx._books, norms, n, 400, L2, live, False, False, bias)
        got = mains[bsz]
        what = f"sift1m-ivfpq group_rows={width} batch {bsz}"
        _identical(torch, got, fused_adc_topk(qd, *args, gids), what + " vs group_ids")
        _identical(torch, got, fused_adc_topk_reference(qd, *args, group_rows=width),
                   what + " vs plain")
        row_order = fused_adc_topk(qd, idx.codes_row, idx._books, idx.rnorms_row,
                                   idx.num_vectors, 400, L2, idx.row_valid, False, False,
                                   bias, idx.row_bucket)
        if not torch.equal(got[0], row_order[0]) or not torch.equal(
                ids[got[1].long().clamp(min=0)].sort(1).values,
                row_order[1].sort(1).values):
            raise AssertionError(f"{what}: scores or rows differ from the row-order form")
        # The tail bucket: the first G - 4 buckets as the groups and N 37
        # rows short of the layout, so the rows past (G - 4)·group_rows (four
        # buckets less 37 rows, more than the stride) take no bias and every
        # query scans them.
        nt, short = n - 37, groups - 4
        targs = (codes[:nt], idx._books, norms[:nt], nt, 400, L2, live[:nt], False, False,
                 bias[:, :short].contiguous())
        tail = f"{what}, N={nt} and {short} groups (a tail of {nt - short * width} rows)"
        _twice_identical(torch, lambda: fused_adc_topk(qd, *targs, group_rows=width), (),
                         fused_adc_topk_reference(qd, *targs, group_rows=width),
                         tail + " vs plain")
        _twice_identical(torch, lambda: fused_adc_topk(qd, *targs, group_rows=width), (),
                         fused_adc_topk(qd, *targs, gids[:nt]), tail + " vs group_ids")
        k2 = lambda p: fused_adc_topk(p[0], *args[:-1], p[1], group_rows=width)  # noqa: E731
        plain = lambda p: fused_adc_topk_reference(p[0], *args[:-1], p[1],  # noqa: E731
                                                   group_rows=width)
        k2(pins[0]), plain(pins[0])
        p1 = cuda_ms(plain, pins[:3], dev)
        a1 = device_ms(k2, pins, dev)
        a2 = device_ms(k2, pins, dev)
        p2 = cuda_ms(plain, pins[:3], dev)
        probed = [p[1] > -1e28 for p in pins]  # this run's work, per call
        pairs = float(np.mean([float((pr.double() @ fill).sum()) for pr in probed]))
        union = float(np.mean([float(fill[pr.any(0)].sum()) for pr in probed]))
        tail = bsz * m * ksub * 2 + bsz * groups * 4 + bsz * 400 * 8
        bnd = bound(2 * m * pairs, union * (cols + 8) + tail)
        cell[bsz] = {"ms": (a1 + a2) / 2, "plain_ms": (p1 + p2) / 2, "bound": bnd}
        say(f"  timing sift1m-ivfpq group_rows={width} ({groups} buckets, {n} slots) "
            f"batch={bsz} fetch=400: {cell[bsz]['ms']:.4f} ms on the device ({a1:.4f}, "
            f"{a2:.4f}) | plain {cell[bsz]['plain_ms']:.4f} | bound of the probed work "
            f"{bnd[0]:.4f} ms ({bnd[1]}), share {bnd[0] / cell[bsz]['ms']:.1%} | {card}")
    return {"launches": launches, "max_err": 0.0, **cell[256]}


def phase_presampled(torch, dev, card, dense, deep, gist, ivf, counters) -> dict:
    """Phase 15 (module docstring): (a) exactness of fused_topk_presampled
    on the card, (b) its phases' times beside plain fused_topk on phases
    3, 13 and 14's corpora and the integer scan's offers and flushes with
    and without the seed (``counters``: the root of phase 1's build of
    tools/wgmma_scan_profile.py's seed_counts variant), (c) the group_rows
    form on sift1m-ivfpq.
    Returns the kernels-line rows of both."""
    import wgmma_scan_profile

    from metrovector_tpu_torch import DistanceMetric
    from metrovector_tpu_torch.ops.topk_kernel import (
        fused_topk, fused_topk_presampled, fused_topk_presampled_reference,
    )

    t_phase = time.perf_counter()
    rng = np.random.default_rng(SEED + 16)
    L2, IP, COS = DistanceMetric.L2, DistanceMetric.INNER_PRODUCT, DistanceMetric.COSINE
    sp = dense
    g = torch.Generator(device=dev).manual_seed(GIST_SEED)
    gist_qs = [torch.randn((256, D_GIST), generator=g, device=dev) for _ in range(5)]
    gist_qs = [q / q.norm(dim=1, keepdim=True) for q in gist_qs]
    # The main path, counted: fused_topk_presampled as a caller runs it
    # (stride 64, k = 100, no pre-sliced subsample) on each corpus, every
    # count at 0 just before and read just after; then each result is held
    # to fused_topk's.
    main = [("phase 3 corpus", torch.from_numpy(rng.integers(0, 256, (256, D_MAIN)).astype(
                 np.float32)).to(dev), sp.data, sp.norms, sp.num_valid, L2, {}),
            ("deep10m", deep["queries"][0], deep["rows"], deep["norms"], deep["num_valid"],
             IP, {"scale": deep["scale"]}),
            ("gist1m", gist_qs[0], gist["data"], gist["norms"], gist["num_valid"], COS,
             {"precision": "high"})]
    routes = ("launches", "launches_int", "launches_high", "launches_affine")
    for attr in routes + ("launches_presampled",):
        setattr(fused_topk, attr, 0)
    outs = [fused_topk_presampled(q, db, nrm, nv, 100, metric, stride=PRE_STRIDE, **kw)
            for _, q, db, nrm, nv, metric, kw in main]
    launches = fused_topk.launches_presampled
    seen = {attr: getattr(fused_topk, attr) for attr in routes}
    if launches != 3 or seen != {"launches": 2, "launches_int": 2, "launches_high": 2,
                                 "launches_affine": 0}:
        raise AssertionError(f"3 presampled calls: {launches} counted, routes {seen}")
    max_err = 0.0
    for (name, q, db, nrm, nv, metric, kw), out in zip(main, outs):
        _identical(torch, out, fused_topk(q, db, nrm, nv, 100, metric, **kw),
                   f"{name}: the presampled main path")
        max_err = max(max_err, _held_to_plain(
            torch, out, fused_topk_presampled_reference(
                q, db, nrm, nv, 100, metric, stride=PRE_STRIDE, **kw),
            q, db, nrm, metric, kw, f"{name}: the presampled main path vs its plain version"))
    say(f"  main path: fused_topk_presampled at k=100 on the phase 3 corpus (batch 256), "
        f"deep10m (128) and gist1m at high (256), identical to fused_topk, to "
        f"fused_topk_presampled_reference on the integer corpora and within phase 13's "
        f"band of it on gist1m (max |score diff| {max_err:.3g}); "
        f"launches_presampled {launches}, phases by route {seen}")
    cases = _presampled_cases(torch, dev, np.random.default_rng(SEED + 15))
    say(f"  (a) fused_topk_presampled on the K1 routes: {cases} cases, each twice "
        f"identical to fused_topk and both plain versions "
        f"({time.perf_counter() - t_phase:.1f} s)")

    times = {}
    for nq in (32, 256):
        qs = [torch.from_numpy(rng.integers(0, 256, (nq, D_MAIN)).astype(np.float32)).to(dev)
              for _ in range(10)]
        for k in (10, 100, 1000):
            kb = bound(2 * nq * N_MAIN * D_MAIN,
                       4 * (N_MAIN * D_MAIN + N_MAIN + nq * D_MAIN) + 8 * nq * k)
            times[("dense", nq, k)] = _presampled_times(
                torch, dev, f"phase 3 corpus 1M x 128 f32 L2 batch={nq}", qs, sp.data,
                sp.norms, sp.num_valid, k, L2, {}, kb, card)
    qs = deep["queries"]
    times[("deep", 128, 100)] = _presampled_times(
        torch, dev, "deep10m int8 IP batch=128", qs, deep["rows"], deep["norms"],
        deep["num_valid"], 100, IP, {"scale": deep["scale"]},
        int_bound(128, deep["rows"].shape[0], D_DEEP, 100), card)
    for k in (18, 100):
        times[("gist", 256, k)] = _presampled_times(
            torch, dev, "gist1m high cosine batch=256", gist_qs, gist["data"], gist["norms"],
            gist["num_valid"], k, COS, {"precision": "high"},
            high_bound(256, gist["num_valid"], D_GIST, k), card)
    t0 = time.perf_counter()
    for name, row in wgmma_scan_profile.seed_counts(counters).items():
        kernels = ", ".join(f"{kn} {v:.4f} ms" for kn, v in row.items()
                            if kn not in ("offers", "flushes"))
        say(f"  (b) integer scan counters at deep10m's shape (10M x 96 random int8, "
            f"batch 128, k=100; tools/wgmma_scan_profile.py --seed-counts): {name}: "
            f"offers {row['offers']:.0f}, flushes {row['flushes']:.0f} | {kernels} | {card}")
    say(f"  (b) counters: {time.perf_counter() - t0:.1f} s")

    top = times[("dense", 256, 100)]
    max_err = max([max_err] + [row["err"] for row in times.values()])

    t0 = time.perf_counter()
    group = _group_rows_on_card(torch, dev, card, ivf)
    say(f"  (c) group_rows: {time.perf_counter() - t0:.1f} s")
    say(f"phase 15 presampled and group_rows: ok ({cases} exact cases; main path "
        f"fused_topk_presampled calls {launches}, group_rows launches "
        f"{group['launches']}; {time.perf_counter() - t_phase:.1f} s)")
    return {"presampled": {"launches": launches, "max_err": max_err, "ms": top["pre"],
                           "plain_ms": top["plain_version"], "bound": top["bound"],
                           "phase1_ms": top["p1"], "phase2_ms": top["p2"]},
            "group_rows": group}


# ------------------------------------------------------------------ phase 16 ---

P16_APPEND, P16_DELETE = 50_000, 1_000
P16_WRITER = (20, 10_000, 100)  # (chunks, rows a chunk, deletes after each)
P16_CLIENTS, P16_REQUESTS = 32, 2_000
P16_PQ_APPEND, P16_IVF_APPEND, P16_IVF_CENTERS = 200_000, 100_000, 8
P16_HNSW_N = 20_000  # the facade's HNSW space: a host build that fits the phase
P16_GROUP = 250  # rows of one appended group in (d): the corpus's ~244 a center
P16_KERNELS = ("fused_topk", "fused_topk[high]", "fused_topk[int8]",
               "fused_topk[affine]", "fused_adc_topk", "fused_adc_topk[int8_mma]",
               "fused_adc_topk[int8_lut]", "fused_adc_topk[group_bias]",
               "rescore_candidates")


def _launch_counts() -> dict:
    """Each kernels-line wrapper's count, by the kernels line's names."""
    from metrovector_tpu_torch.ops.adc_kernel import fused_adc_topk as a
    from metrovector_tpu_torch.ops.gather_kernel import gather_rows, rescore_candidates
    from metrovector_tpu_torch.ops.sparse_kernel import ell_topk, query_postings
    from metrovector_tpu_torch.ops.topk_kernel import fused_topk as t

    return {"fused_topk": t.launches, "fused_topk[high]": t.launches_high,
            "fused_topk[int8]": t.launches_int, "fused_topk[affine]": t.launches_affine,
            "fused_topk_presampled": t.launches_presampled,
            "fused_adc_topk": a.launches - a.int8_launches - a.group_launches,
            "fused_adc_topk[int8_mma]": a.int8_mma_launches,
            "fused_adc_topk[int8_lut]": a.int8_launches - a.int8_mma_launches,
            "fused_adc_topk[group_bias]": a.group_launches - a.group_rows_launches,
            "fused_adc_topk[group_rows]": a.group_rows_launches,
            "gather_rows": gather_rows.launches,
            "rescore_candidates": rescore_candidates.launches,
            "ell_topk": ell_topk.launches, "query_postings": query_postings.launches}


def _zero_counts() -> None:
    from metrovector_tpu_torch.ops.adc_kernel import fused_adc_topk as a
    from metrovector_tpu_torch.ops.gather_kernel import gather_rows, rescore_candidates
    from metrovector_tpu_torch.ops.sparse_kernel import ell_topk, query_postings
    from metrovector_tpu_torch.ops.topk_kernel import fused_topk as t

    for name in ("launches", "launches_high", "launches_int", "launches_affine",
                 "launches_presampled"):
        setattr(t, name, 0)
    for name in ("launches", "int8_launches", "int8_mma_launches", "group_launches",
                 "group_rows_launches"):
        setattr(a, name, 0)
    gather_rows.launches = rescore_candidates.launches = 0
    ell_topk.launches = query_postings.launches = 0


class _Tally:
    """Phase 16's launches on its main path: every count set to 0 just
    before a public call, read just after and added here. Launches made to
    compare a kernel with its plain version happen outside and are not
    counted."""

    def __init__(self):
        self.counts = {}

    def add(self) -> None:
        """Add the counts since the last ``_zero_counts``."""
        for name, n in _launch_counts().items():
            self.counts[name] = self.counts.get(name, 0) + n

    def __call__(self, fn, *args, **kw):
        _zero_counts()
        out = fn(*args, **kw)
        self.add()
        return out


@contextlib.contextmanager
def plain_versions():
    """The port's search paths with each kernel's wrapper swapped for its
    plain version in the modules that call it (this script's swap; the
    port is unchanged): a search inside runs no kernel."""
    import metrovector_tpu_torch.engine as eng_mod
    import metrovector_tpu_torch.index.ivfpq as ivfpq_mod
    import metrovector_tpu_torch.index.pq as pq_mod
    import metrovector_tpu_torch.parallel.sharded_search as sharded_mod
    import metrovector_tpu_torch.parallel.sparse_sharded as sparse_sharded_mod
    from metrovector_tpu_torch.ops.adc_kernel import fused_adc_topk_reference
    from metrovector_tpu_torch.ops.gather_kernel import rescore_candidates_reference
    from metrovector_tpu_torch.ops.sparse_kernel import ell_topk_reference
    from metrovector_tpu_torch.ops.topk_kernel import fused_topk_reference

    def adc(*args, buckets=None, grid=None, **kw):  # the rows in order; no grid
        return fused_adc_topk_reference(*args, **kw)

    def topk(*args, grid=None, **kw):  # the plain version has no grid
        return fused_topk_reference(*args, **kw)

    def rescore_rows(q, db, norms, cand, k, metric):
        return rescore_candidates_reference(q, db, norms, cand, k, metric, tie="row")

    swaps = ((eng_mod, "fused_topk", topk),
             (eng_mod, "rescore_topk", rescore_rows),
             (pq_mod, "fused_adc_topk", adc),
             (pq_mod, "rescore_candidates", rescore_candidates_reference),
             (ivfpq_mod, "fused_adc_topk", adc),
             (ivfpq_mod, "rescore_candidates", rescore_candidates_reference),
             (sharded_mod, "fused_topk", topk),
             (sharded_mod, "fused_adc_topk", adc),
             (sharded_mod, "rescore_candidates", rescore_candidates_reference),
             (sparse_sharded_mod, "ell_topk",
              lambda *args: ell_topk_reference(*args[:11])))  # no grid
    saved = [(mod, name, getattr(mod, name)) for mod, name, _ in swaps]
    for mod, name, fn in swaps:
        setattr(mod, name, fn)
    try:
        yield
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


def _same_result(got, ref, what) -> None:
    if not (np.array_equal(got.indices, ref.indices)
            and np.array_equal(got.scores, ref.scores)
            and np.array_equal(got.ids, ref.ids)):
        raise AssertionError(f"{what}: differs from the plain version")


def _no_deleted(res, dead: set, what) -> None:
    if dead and np.isin(res.indices, np.fromiter(dead, np.int64)).any():
        raise AssertionError(f"{what}: a deleted row surfaced")


def _timed_add(torch, dev, fn, *args, **kw) -> float:
    """ms of one mutation, the device synchronized before and after."""
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    fn(*args, **kw)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return (time.perf_counter() - t0) * 1e3


def _p16_dense(torch, dev, card, tally, path, name, sizes) -> dict:
    """(a) the phase 3 file through the facade, grown across and within
    capacity, with deletes by id and by position, each step's search at
    batch 256 identical to the plain version; add_rows and search() times."""
    from metrovector_tpu_torch import Database

    n_add, n_del, nq = sizes
    rng = np.random.default_rng(SEED + 16)
    eng = Database.open(path, device=dev).engine(name, mode="exact")
    sp = eng.space
    n0, cap0 = sp.num_valid, sp.padded_rows
    hosts = [rng.integers(0, 256, (nq, sp.dim)).astype(np.float32) for _ in range(5)]
    p50_before = _p50(torch, eng.search, hosts, dev, k=10) if dev.type == "cuda" else 0.0
    dead: set = set()

    def check(step):
        res = tally(eng.search, hosts[0], k=10)
        with plain_versions():
            ref = eng.search(hosts[0], k=10)
        _same_result(res, ref, f"(a) {step}")
        _no_deleted(res, dead, f"(a) {step}")

    ms_grow = _timed_add(torch, dev, sp.add_rows,
                         rng.integers(0, 256, (n_add, sp.dim)).astype(np.float32))
    if not sp.padded_rows > cap0 or sp.num_valid != n0 + n_add:
        raise AssertionError("(a) the first append did not cross capacity")
    check("grown across capacity")
    ptr, cap1 = sp.data.data_ptr(), sp.padded_rows
    ms_within = _timed_add(torch, dev, sp.add_rows,
                           rng.integers(0, 256, (n_add, sp.dim)).astype(np.float32))
    if sp.data.data_ptr() != ptr or sp.padded_rows != cap1:
        raise AssertionError("(a) an append within capacity moved the corpus")
    check("grown within capacity")
    by_id = rng.choice(sp.num_valid, n_del, replace=False)
    sp.delete_rows(ids=by_id)  # no ID column: an id is its row
    dead.update(by_id.tolist())
    by_pos = rng.choice(np.setdiff1d(np.arange(sp.num_valid), by_id), n_del, replace=False)
    sp.delete_rows(rows=by_pos)
    dead.update(by_pos.tolist())
    check("after deletes")
    p50_after = _p50(torch, eng.search, hosts, dev, k=10) if dev.type == "cuda" else 0.0
    say(f"  (a) {name}: {n0} rows -> {sp.num_valid} ({cap0} -> {sp.padded_rows} "
        f"capacity); add_rows of {n_add} rows at a growth step {ms_grow:.2f} ms, within "
        f"capacity {ms_within:.2f} ms (synchronized; data_ptr unchanged); {2 * n_del} "
        f"deleted; batch {nq} k=10 identical to the plain version at each step; "
        f"search() p50 {p50_before:.4f} ms before growth, {p50_after:.4f} ms after | {card}")
    return {"grow_ms": ms_grow, "within_ms": ms_within, "p50": (p50_before, p50_after)}


def _p16_verified(torch, dev, card, tally, path, name, sizes) -> None:
    """(a) high_verified after rows of 4x the corpus's largest norm: equal
    to "highest", with the fallbacks counted."""
    from metrovector_tpu_torch import Database
    from metrovector_tpu_torch.ops.topk_kernel import fused_topk_reference

    n_add, _, nq = sizes
    rng = np.random.default_rng(SEED + 161)
    db = Database.open(path, device=dev, engine_kwargs={"precision": "high_verified"})
    eng = db.engine(name, mode="exact")
    sp = eng.space
    x = sp.data[: sp.num_valid]
    big = (2 * x[torch.argmax(sp.norms[: sp.num_valid])]).cpu().numpy()
    rows = np.repeat(big[None, : sp.dim], n_add // 10, axis=0)
    rows[:, 0] += np.arange(rows.shape[0], dtype=np.float32) % 7  # norms ~4x the largest
    sp.add_rows(rows)
    q = rng.integers(0, 256, (nq, sp.dim)).astype(np.float32)
    res = tally(eng.search, q, k=10)
    snap = sp.snapshot
    prep = sp.prepare_queries(q)
    s_r, i_r = fused_topk_reference(prep.qdev, snap.data, snap.norms, snap.num_valid,
                                    10, sp.metric, valid_mask=snap.valid_mask)
    if not (np.array_equal(res.indices, i_r.cpu().numpy())
            and np.array_equal(res.scores, s_r.cpu().numpy())):
        raise AssertionError("(a) high_verified after the 4x-norm rows differs from highest")
    say(f"  (a) high_verified: {rows.shape[0]} rows of ~4x the largest norm appended "
        f"({sp.num_valid} rows); batch {nq} identical to the plain 'highest'; "
        f"verify_stats {eng.verify_stats} | {card}")


def _p16_space(torch, dev, card, tally, eng, label, rows_fn, sizes, band=None) -> None:
    """(a) one resident space (int8, uint8, bf16) grown across and within
    capacity and trimmed, each step's search equal to the plain version
    (``band(q)``: a check within a band of it, for uint8 cosine)."""
    n_add, n_del, nq = sizes
    rng = np.random.default_rng(SEED + 162)
    sp = eng.space
    n0, cap0 = sp.num_valid, sp.padded_rows
    q = rows_fn(rng, nq)
    check = band(q) if band is not None else None
    dead: set = set()
    ms = []
    for step in ("across capacity", "within capacity", "after deletes"):
        if step == "after deletes":
            victims = rng.choice(sp.num_valid, n_del, replace=False)
            sp.delete_rows(rows=victims)
            dead.update(victims.tolist())
        else:
            ms.append(_timed_add(torch, dev, sp.add_rows, rows_fn(rng, n_add)))
        res = tally(eng.search, q, k=10)
        with plain_versions():
            ref = eng.search(q, k=10)
        _no_deleted(res, dead, f"(a) {label} {step}")
        if check is None:
            _same_result(res, ref, f"(a) {label} {step}")
        else:
            check(res, ref, f"(a) {label} {step}")
    if not sp.padded_rows > cap0:
        raise AssertionError(f"(a) {label}: no growth step")
    say(f"  (a) {label}: {n0} -> {sp.num_valid} rows ({cap0} -> {sp.padded_rows} "
        f"capacity), float rows quantized by the space's calibration where it is "
        f"integer; add_rows {ms[0]:.2f} ms at the growth step, {ms[1]:.2f} ms within; "
        f"batch {nq} k=10 {'within the band of' if band else 'identical to'} the "
        f"plain version at each step | {card}")


class _RowScores:
    """float64 scores ``[Q, N]`` on the card, read back only where
    ``_compare`` looks (``[row, columns]``)."""

    def __init__(self, torch, t):
        self.torch, self.t = torch, t

    def __getitem__(self, key):
        r, cols = key
        idx = self.torch.as_tensor(np.asarray(cols, np.int64), device=self.t.device)
        return self.t[r, idx].cpu().numpy()


def _cosine_band(torch, sp, q):
    """uint8 cosine search() against its plain version: phase 14's band,
    differing rows only at near-ties of the exact (float64) similarity."""

    def check(res, ref, what):
        t = torch.from_numpy
        tol = np.full(len(res.indices), 4 * sp.dim * 2.0**-24 + 2.0**-22)
        scores64 = None
        if not np.array_equal(res.indices, ref.indices):
            snap = sp.snapshot
            xd = ((snap.data[: snap.num_valid, : sp.dim].double() + 128 - sp.zero_point)
                  * sp.scale)
            inv = 1.0 / torch.sqrt((xd * xd).sum(1))
            q64 = sp.prepare_queries(q).qdev[:, : sp.dim].double()
            scores64 = _RowScores(torch, (q64 @ xd.T) * inv[None, :])
        _compare((t(res.scores), t(res.indices)), (t(ref.scores), t(ref.indices)),
                 False, tol, scores64, what)
    return check


def _p16_serving(torch, dev, card, tally, path, name, pipeline, sizes) -> dict:
    """(b) MicroBatcher over a fresh engine of the phase 3 file while a
    writer appends and deletes: every answer checked against what was
    published when it returned."""
    from metrovector_tpu_torch import Database, MicroBatcher

    chunks, chunk_rows, n_del = P16_WRITER if sizes is None else sizes[0]
    clients, requests = (P16_CLIENTS, P16_REQUESTS) if sizes is None else sizes[1]
    eng = Database.open(path, device=dev).engine(name, mode="exact")
    sp = eng.space
    n0, cap0 = sp.num_valid, sp.padded_rows
    rng = np.random.default_rng(SEED + 163 + int(pipeline))
    deleted_at: list = []
    errors: list = []
    answers: list = []
    lock = threading.Lock()

    def writer():
        try:
            for _ in range(chunks):
                sp.add_rows(rng.integers(0, 256, (chunk_rows, sp.dim)).astype(np.float32))
                victims = rng.choice(sp.num_valid, n_del, replace=False)
                sp.delete_rows(rows=victims)
                deleted_at.append((time.monotonic(), victims))
        except BaseException as e:  # noqa: BLE001
            errors.append(e)

    def client(c):
        crng = np.random.default_rng(10_000 + c)
        try:
            for _ in range(requests // clients + (c < requests % clients)):
                q = crng.integers(0, 256, (1, sp.dim)).astype(np.float32)
                t0 = time.monotonic()
                res = mb.submit(q).result(timeout=120)
                nv = sp.num_valid
                with lock:
                    answers.append((t0, res, nv))
        except BaseException as e:  # noqa: BLE001
            errors.append(e)

    t_run = time.perf_counter()
    _zero_counts()
    with MicroBatcher(eng, k=10, max_batch=256, max_wait_ms=1.0, pipeline=pipeline) as mb:
        threads = [threading.Thread(target=client, args=(c,)) for c in range(clients)]
        threads.append(threading.Thread(target=writer))
        for t in threads:
            t.start()
        for t in threads:
            t.join()
    tally.add()
    t_run = time.perf_counter() - t_run
    if errors:
        raise errors[0]
    if len(answers) != requests:
        raise AssertionError(f"(b) {len(answers)} answers of {requests}")
    if not sp.padded_rows > cap0:
        raise AssertionError("(b) the writer crossed no capacity step")
    for t0, res, nv in answers:
        rows = res.indices[res.indices >= 0]
        if (rows >= nv).any():
            raise AssertionError("(b) an answer names a row past the published count")
        gone = [v for t, v in deleted_at if t < t0]
        if gone and np.isin(rows, np.concatenate(gone)).any():
            raise AssertionError("(b) an answer holds a row deleted before its submit")
        if not np.array_equal(res.ids[res.indices >= 0], rows.astype(np.uint64)):
            raise AssertionError("(b) an answer's ids do not match its rows")
    q = rng.integers(0, 256, (256, sp.dim)).astype(np.float32)
    res = tally(eng.search, q, k=10)
    with plain_versions():
        ref = eng.search(q, k=10)
    _same_result(res, ref, "(b) after the writer stopped")
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)  # a faulted launch would raise here
    say(f"  (b) MicroBatcher pipeline={pipeline}: {clients} clients, {requests} "
        f"requests answered in {t_run:.2f} s while a writer appended {chunks} x "
        f"{chunk_rows} rows and deleted {n_del} after each ({n0} -> {sp.num_valid} "
        f"rows, {cap0} -> {sp.padded_rows} capacity); every answer below the row count "
        f"published when it returned, none deleted before its submit, ids = rows; "
        f"after the writer, identical to the plain version | {card}")
    return {"seconds": t_run}


def _grown_oracle(torch, dev, x_old, new, dead):
    """float64 rows and norms on the card of the grown corpus, a deleted
    row's norm +inf (so ``_recall_on_card`` never counts it a neighbour)."""
    x64 = torch.cat([x_old.double(), torch.from_numpy(new).to(dev, torch.float64)])
    norms64 = (x64 * x64).sum(1)
    if dead:
        norms64[torch.as_tensor(sorted(dead), device=dev)] = float("inf")
    return x64, norms64


def _p16_pq(torch, dev, card, tally, idx, name, sizes) -> dict:
    """(c) a phase 8 index grown across capacity and trimmed: K2 and K3
    against their plain versions on the grown index (phase 8's rule), the
    f32 and the int8 LUT, recall@10 against the float64 oracle."""
    from metrovector_tpu_torch import DistanceMetric
    from metrovector_tpu_torch.index.pq import unpack_codes4
    from metrovector_tpu_torch.ops.adc_kernel import (
        adc_lut, fused_adc_topk, fused_adc_topk_reference,
    )
    from metrovector_tpu_torch.ops.gather_kernel import (
        rescore_candidates, rescore_candidates_reference,
    )

    L2 = DistanceMetric.L2
    n_add, n_del, nq = sizes
    rng = np.random.default_rng(SEED + 164)
    n0, cap0 = idx.num_vectors, int(idx.codes.shape[0])
    x_old = idx.db[:n0]
    x_host = x_old.cpu().numpy()
    new = _pq_queries(rng, x_host, n_add)  # noisy copies of corpus rows
    ms = _timed_add(torch, dev, idx.add_rows, new)
    if not int(idx.codes.shape[0]) > cap0:
        raise AssertionError(f"(c) {name}: the append did not cross capacity")
    dead = set(rng.choice(idx.num_vectors, n_del, replace=False).tolist())
    idx.delete_rows(sorted(dead))
    x64, norms64 = _grown_oracle(torch, dev, x_old, new, dead)
    grown = np.concatenate([x_host, new])
    q = np.concatenate([_pq_queries(rng, new, nq // 2), _pq_queries(rng, x_host, nq - nq // 2)])
    qd = torch.from_numpy(q).to(dev)
    out = {}
    for int8 in (False, True):
        lut_name = "int8 LUT" if int8 else "f32 LUT"
        res = tally(idx.search, q, k=10, rerank=RERANK, int8_lut=int8)
        _no_deleted(res, dead, f"(c) {name} {lut_name}")
        rec = _recall_on_card(torch, x64, norms64, q, res.indices, 10)
        if rec < 0.99:
            raise AssertionError(f"(c) {name} {lut_name}: recall@10 {rec:.4f} < 0.99")
        args = (qd, idx.codes, idx._books, idx.recon_norms, idx.num_vectors, RERANK, L2)
        kw = dict(valid_mask=idx.valid, exact_lut=not int8, packed4=idx.packed4,
                  int8_lut=int8)
        got = fused_adc_topk(*args, **kw)
        ref = fused_adc_topk_reference(*args, **kw)
        if int8:
            _identical(torch, got, ref, f"(c) {name} int8 LUT: K2")
        else:
            codes = idx.codes[: idx.num_vectors].cpu().numpy()
            if idx.packed4:
                codes = unpack_codes4(codes, idx.m)
            _same_candidates(torch, got, ref, adc_lut(qd, idx._books, True), codes,
                             idx.recon_norms[: idx.num_vectors].cpu().numpy(), idx.m,
                             idx.ksub, f"(c) {name} f32 LUT: K2")
        k3 = rescore_candidates(qd, idx.db, idx.db_norms, got[1], 10, L2, tie="position")
        k3_ref = rescore_candidates_reference(qd, idx.db, idx.db_norms, got[1], 10, L2,
                                              tie="position")
        _identical(torch, k3, k3_ref, f"(c) {name} {lut_name}: K3")
        if not (np.array_equal(res.indices, k3[1].cpu().numpy())
                and np.array_equal(res.scores, k3[0].cpu().numpy())):
            raise AssertionError(f"(c) {name} {lut_name}: search() is not K2 then K3")
        out[lut_name] = rec
    del x64, norms64, grown
    say(f"  (c) {name}: {n0} -> {idx.num_vectors} rows ({cap0} -> "
        f"{int(idx.codes.shape[0])} capacity; add_rows of {n_add} rows {ms:.1f} ms, "
        f"encoded on the card), {n_del} deleted; batch {nq} k=10 rerank {RERANK}: "
        + ", ".join(f"{k} recall@10 {v:.4f}" for k, v in out.items())
        + f"; K2 and K3 as their plain versions on the grown index | {card}")
    return out


def _p16_ivfpq(torch, dev, card, tally, idx, sizes) -> dict:
    """(d) phase 12's sift1m-ivfpq grown by rows of the corpus's own shape
    (groups of 250 at spread 12, as ``_clustered_u8_corpus`` draws them)
    around centers drawn off rows of a few clusters, which overflow into
    new buckets; both modes at batches 1, 8 and 256 identical to their
    plain versions and recall@10 >= 0.99 at rerank 400; then deletes,
    rebuild() and again; IVF flat the same.

    The groups' centers lie 64 a dimension off a row of their cluster, so
    that groups do not overlap: near copies of the cluster's rows, or
    groups on top of its own, would raise the density around a query some
    tenfold, and a fetch of 400 candidates would then miss true neighbours
    whatever the code (recall at a fixed re-rank depth measures the data
    as much as the index)."""
    from metrovector_tpu_torch import DistanceMetric
    from metrovector_tpu_torch.index.ivf import IVFIndex

    L2 = DistanceMetric.L2
    n_add, n_del, batches, centers = sizes
    rng = np.random.default_rng(SEED + 165)
    n0, nb0 = idx.num_vectors, idx.num_buckets
    x_old = idx.db[:n0]
    x_host = x_old.cpu().numpy()
    assign0 = idx.cells[np.maximum(idx.row_bucket_host[:n0], 0)].astype(np.int32)
    which = rng.choice(idx.num_clusters, centers, replace=False)
    groups = n_add // P16_GROUP
    seeds = (x_host[rng.choice(np.flatnonzero(np.isin(assign0, which)), groups)]
             + rng.normal(0.0, 64.0, (groups, idx.dim)))
    new = np.clip(np.rint(seeds[rng.integers(0, groups, n_add)]
                          + rng.normal(0.0, 12.0, (n_add, idx.dim))), 0, 255).astype(np.float32)
    ms = _timed_add(torch, dev, idx.add_rows, new)
    nb1 = idx.num_buckets
    if not nb1 > nb0:
        raise AssertionError("(d) the overflow allocated no bucket")
    in_new = int((idx.row_bucket_host[n0:] >= nb0).sum())
    qs = {b: np.concatenate([_pq_queries(rng, new, b - b // 2), _pq_queries(rng, x_host, b // 2)])
          for b in batches}
    dead: set = set()
    recalls = {}
    for stage in ("appended", "deleted + rebuild()"):
        if stage != "appended":
            dead = set(rng.choice(idx.num_vectors, n_del, replace=False).tolist())
            idx.delete_rows(sorted(dead))
            idx.rebuild()
        x64, norms64 = _grown_oracle(torch, dev, x_old, new, dead)
        for mode in ("scan", "probe"):
            rows, hits_new = [], 0
            for b in batches:
                res = tally(idx.search, qs[b], k=10, nprobe=IVF_NPROBE, rerank=RERANK,
                            mode=mode)
                with plain_versions():
                    ref = idx.search(qs[b], k=10, nprobe=IVF_NPROBE, rerank=RERANK,
                                     mode=mode)
                _same_result(res, ref, f"(d) {stage} {mode} batch {b}")
                _no_deleted(res, dead, f"(d) {stage} {mode} batch {b}")
                rows.append(res.indices)
                hits_new += int((res.indices[: b - b // 2] >= n0).sum())
            q_all = np.concatenate([qs[b] for b in batches])
            rec = _recall_on_card(torch, x64, norms64, q_all, np.concatenate(rows), 10)
            if rec < 0.99 or hits_new == 0:
                raise AssertionError(f"(d) {stage} {mode}: recall@10 {rec:.4f}, "
                                     f"{hits_new} appended rows returned")
            recalls[(stage, mode)] = (rec, hits_new)
        del x64, norms64
    say(f"  (d) sift1m-ivfpq: {n0} -> {idx.num_vectors} rows, {n_add} in {groups} "
        f"groups drawn off rows of {centers} clusters (add_rows {ms:.1f} ms); {nb0} -> {nb1} buckets "
        f"({in_new} appended rows in new buckets), {idx.num_buckets} after "
        f"rebuild(); {n_del} deleted; "
        f"nprobe {IVF_NPROBE} rerank {RERANK}, batches {batches}, each identical to its "
        "plain version: " + ", ".join(
            f"{s} {m} recall@10 {r:.4f} ({h} appended rows returned)"
            for (s, m), (r, h) in recalls.items()) + f" | {card}")

    # IVF flat: the same overflow case over the same rows and quantizer
    norms = np.einsum("ij,ij->i", x_host, x_host, dtype=np.float64).astype(np.float32)
    flat = IVFIndex.build(x_host, norms, L2, idx.num_clusters, centroids=idx.centroids,
                          assignments=assign0, device=dev)
    fb0 = flat.num_buckets
    ms_flat = _timed_add(torch, dev, flat.add_rows, new)
    if not flat.num_buckets > fb0:
        raise AssertionError("(d) IVF flat: the overflow allocated no bucket")
    x64, norms64 = _grown_oracle(torch, dev, x_old, new, set())
    q = qs[batches[-1]]
    res = tally(flat.search, q, k=10, nprobe=IVF_NPROBE)
    rec = _recall_on_card(torch, x64, norms64, q, res.indices, 10)
    own = flat.search(new[:64], k=1, nprobe=IVF_NPROBE).indices[:, 0]
    if rec < 0.99 or not (own >= n0).all():
        raise AssertionError(f"(d) IVF flat: recall@10 {rec:.4f}, appended rows "
                             f"found {(own >= n0).mean():.3f}")
    del x64, norms64
    say(f"  (d) IVF flat over the same rows and quantizer: {fb0} -> {flat.num_buckets} "
        f"buckets after the same append (add_rows {ms_flat:.1f} ms); batch "
        f"{batches[-1]} nprobe {IVF_NPROBE} recall@10 {rec:.4f}; each appended row "
        f"its own nearest | {card}")
    return {"assign0": assign0}


def _p16_facade(torch, dev, card, tally, tmpdir, pq8, ivf, assign0, n_hnsw, nq) -> None:
    """(e) Database over one file with a PQ, an IVF-PQ, an IVF and an HNSW
    space: mode="auto" routes each to its index (identical to the index's
    plain versions), mode="exact" bypasses them, a budget that holds one
    space evicts the least recently used, the batcher answers as search."""
    from metrovector_tpu_torch import Builder, Database, DistanceMetric
    from metrovector_tpu_torch.database import IndexEngine
    from metrovector_tpu_torch.engine import SearchEngine
    from metrovector_tpu_torch.index.hnsw import HNSWIndex

    L2 = DistanceMetric.L2
    t0 = time.perf_counter()
    n = pq8.num_vectors
    x_pq = pq8.db[:n].cpu().numpy()
    x_ivf = ivf.db[: len(assign0)].cpu().numpy()
    graph = HNSWIndex.build(x_ivf[:n_hnsw], L2, m=16, ef_construction=100)
    t_hnsw = time.perf_counter() - t0
    path = os.path.join(tmpdir, "facade.mvt")
    b = Builder()
    for space, rows in (("pq", x_pq), ("ivfpq", x_ivf), ("ivf", x_ivf),
                        ("hnsw", x_ivf[:n_hnsw])):
        b.add_vector_space(space, dim=rows.shape[1], metric=L2)
        b.add_vectors(space, rows)
    b.set_pq_index("pq", pq8.codebooks, pq8.codes[:n].cpu().numpy())
    for space in ("ivfpq", "ivf"):
        b.set_ivf_index(space, ivf.centroids, assign0, nprobe=IVF_NPROBE)
    b.set_pq_index("ivfpq", ivf.codebooks, ivf.codes_row[: len(assign0)].cpu().numpy(),
                   residual=True)
    b.set_hnsw_index("hnsw", graph.layers, graph.entry, m=16, ef_construction=100)
    b.build().save(path)
    t_file = time.perf_counter() - t0
    rng = np.random.default_rng(SEED + 166)
    q = _pq_queries(rng, x_ivf[:n_hnsw], nq)
    db = Database.open(path, device=dev)
    for space in ("pq", "ivfpq", "ivf", "hnsw"):
        if db.index_kind(space) != space:
            raise AssertionError(f"(e) {space}: detected {db.index_kind(space)}")
        eng = db.engine(space)
        if not (isinstance(eng, IndexEngine) and eng.kind == space):
            raise AssertionError(f"(e) {space}: mode='auto' did not route to its index")
        res = tally(db.search, space, q, k=10)
        with plain_versions():
            ref = db.search(space, q, k=10)
        _same_result(res, ref, f"(e) {space} through the facade")
        if db.engine(space).nbytes != db._estimate_nbytes(space, space):
            raise AssertionError(f"(e) {space}: the footprint estimate is not nbytes")
    exact = db.engine("ivf", mode="exact")
    if not isinstance(exact, SearchEngine):
        raise AssertionError("(e) mode='exact' did not bypass the index")
    res = tally(db.search, "ivf", q, k=10, mode="exact")
    with plain_versions():
        ref = db.search("ivf", q, k=10, mode="exact")
    _same_result(res, ref, "(e) ivf mode='exact'")
    one = db._estimate_nbytes("pq")
    small = Database.open(path, device=dev, hbm_budget=one)
    tally(small.search, "pq", q, k=10, mode="exact")
    tally(small.search, "ivf", q, k=10, mode="exact")
    if list(small._engines) != ["ivf"] or small.resident_bytes != one:
        raise AssertionError(f"(e) the budget kept {list(small._engines)}")
    with db.batcher("pq", k=10, max_batch=64, max_wait_ms=1.0) as mb:
        futs = [mb.submit(q[i]) for i in range(len(q))]
        got = [f.result(timeout=120) for f in futs]
    direct = db.search("pq", q, k=10)
    for i, r in enumerate(got):
        if not (np.array_equal(r.indices[0], direct.indices[i])
                and np.array_equal(r.scores[0], direct.scores[i])):
            raise AssertionError(f"(e) batcher answer {i} differs from search()")
    del db, small
    say(f"  (e) Database over {n} x {x_pq.shape[1]} PQ, IVF-PQ and IVF spaces and a "
        f"{n_hnsw}-row HNSW space (host build {t_hnsw:.1f} s on all cores; file "
        f"written {t_file:.1f} s): mode='auto' routed each to its index (identical to "
        f"its plain versions, footprint estimate = nbytes), mode='exact' to "
        f"SearchEngine; a budget of one space ({one} bytes) evicted the least recently "
        f"used; the batcher's {len(q)} answers equal search() | {card}")


def phase_mutation(torch, dev, card, sift_path, dense, quant16, pq4, pq8, ivf) -> dict:
    """Phase 16 (module docstring). Returns its launches by kernels-line
    name and its times."""
    from metrovector_tpu_torch import Builder, DataType, Reader, SearchEngine

    t_phase = time.perf_counter()
    tally = _Tally()
    sizes = (P16_APPEND, P16_DELETE, 256)
    times = _p16_dense(torch, dev, card, tally, sift_path, "sift", sizes)
    _p16_verified(torch, dev, card, tally, sift_path, "sift", sizes)
    deep, u8, u8cos = quant16["deep"], quant16["u8"], quant16["u8cos"]
    ds = deep.space
    _p16_space(torch, dev, card, tally, deep, "deep10m int8 IP", lambda r, n: (
        r.integers(-128, 128, (n, ds.dim)) * ds.scale
        + r.uniform(-0.4, 0.4, (n, ds.dim)) * ds.scale).astype(np.float32), sizes)
    _p16_space(torch, dev, card, tally, u8, "sift1m-u8 uint8 L2", lambda r, n:
               r.uniform(0, 255, (n, D_MAIN)).astype(np.float32), sizes)
    cs = u8cos.space
    _p16_space(torch, dev, card, tally, u8cos, "uint8 cosine (affine load)",
               lambda r, n: ((r.integers(0, 256, (n, D_MAIN)) - cs.zero_point) * cs.scale
                             ).astype(np.float32), sizes,
               band=lambda q: _cosine_band(torch, cs, q))
    del deep, u8, u8cos, ds, cs
    quant16.clear()
    tmp = tempfile.TemporaryDirectory()
    try:
        x = dense.data[: dense.num_valid, : dense.dim].cpu().numpy()
        bf_path = os.path.join(tmp.name, "sift1m_bf16.mvt")
        b = Builder()
        b.add_vector_space("bf", dim=D_MAIN, dtype=DataType.BFLOAT16)
        b.add_vectors("bf", x)
        b.build().save(bf_path)
        del b, x
        bf = SearchEngine(Reader.open(bf_path).vector_space("bf"), device=dev)
        _p16_space(torch, dev, card, tally, bf, "phase 3 corpus as BFLOAT16",
                   lambda r, n: r.integers(0, 256, (n, D_MAIN)).astype(np.float32), sizes)
        del bf
        torch.cuda.empty_cache()
        for pipeline in (False, True):
            _p16_serving(torch, dev, card, tally, sift_path, "sift", pipeline, None)
        torch.cuda.empty_cache()
        assign0 = ivf.cells[np.maximum(ivf.row_bucket_host[: ivf.num_vectors], 0)]
        _p16_facade(torch, dev, card, tally, tmp.name, pq8, ivf, assign0.astype(np.int32),
                    P16_HNSW_N, 256)
        torch.cuda.empty_cache()
    finally:
        tmp.cleanup()
    for name, idx in (("sift1m-pq4", pq4), ("sift1m-pq", pq8)):
        _p16_pq(torch, dev, card, tally, idx, name, (P16_PQ_APPEND, P16_DELETE, 256))
        torch.cuda.empty_cache()
    _p16_ivfpq(torch, dev, card, tally, ivf,
               (P16_IVF_APPEND, P16_DELETE, IVF_KERNEL_BATCHES, P16_IVF_CENTERS))
    torch.cuda.synchronize(dev)  # no launch of the phase faulted
    missing = [k for k in P16_KERNELS if not tally.counts.get(k)]
    if missing:
        raise AssertionError(f"phase 16: no launch of {missing} on its main path")
    seconds = time.perf_counter() - t_phase
    say(f"  phase 16 times: add_rows {times['grow_ms']:.2f} ms at a growth step "
        f"(1M -> 1.05M rows of 128 f32), {times['within_ms']:.2f} ms within capacity; "
        f"search() p50 batch 256 k=10 {times['p50'][0]:.4f} ms before growth, "
        f"{times['p50'][1]:.4f} ms after; the phase {seconds:.1f} s | {card}")
    say(f"phase 16 mutation and the facade: ok (launches "
        + ", ".join(f"{k} {tally.counts.get(k, 0)}" for k in P16_KERNELS) + ")")
    return {"launches": tally.counts, "times": times, "seconds": seconds}


# ---------------------------------------------------------------- phase 17 ---

P17_KERNELS = ("fused_topk", "fused_topk[int8]", "fused_adc_topk",
               "fused_adc_topk[int8_mma]", "fused_adc_topk[group_bias]",
               "rescore_candidates", "ell_topk", "query_postings")
P17_DIR: str | None = None  # copies of earlier phases' files, set by _main
P17_FILES: dict[str, str] = {}
P17_FETCH, P17_IVF_BATCHES = 400, (8, 256)
P17_ITERS = 10  # timings a candidate after its warm-up, best of


def _keep_for_p17(name: str, path: str) -> None:
    """Copy an earlier phase's file for phases 17 and 18, which persist
    tuned grids into their copies (never into a file another phase or
    ``--parent`` reads)."""
    if P17_DIR is not None:
        dst = os.path.join(P17_DIR, name + ".mvt")
        shutil.copyfile(path, dst)
        P17_FILES[name] = dst


def _identical_result(got, ref, what) -> None:
    if not (np.array_equal(got.indices, ref.indices)
            and np.array_equal(got.scores, ref.scores)
            and np.array_equal(got.ids, ref.ids)):
        raise AssertionError(f"{what}: not identical")


def _p17_tune(card, tally, label, owner, reopen, search, queries, **autotune_kw) -> dict:
    """(a) for one engine ``owner``, opened from its file's copy:
    ``search(owner, q, grid)`` runs one search (grid None: the owner's).
    The owner's grid is cleared (a grid persisted by an earlier tuning of
    the copy), the default plan's answer taken, then
    ``autotune(persist=True)`` (counted), every measured candidate's answer
    identical to the default's, the winner applied, a fresh ``reopen()``
    adopting it and searching identically again (counted)."""
    from metrovector_tpu_torch.ops.grid import Grid

    owner.grid = None
    default = search(owner, queries, None)
    report = tally(owner.autotune, queries=queries, persist=True, iters=P17_ITERS,
                   **autotune_kw)
    measured = [r for r in report if "skipped" not in r and np.isfinite(r["ms"])]
    for row in measured:
        _identical_result(search(owner, queries, Grid(row["waves"], row["tile"])), default,
                          f"{label} waves {row['waves']} tile {row['tile']}")
    winner = Grid(report[0]["waves"], report[0]["tile"])
    if owner.grid != winner:
        raise AssertionError(f"{label}: the winner {winner} was not applied")
    fresh = reopen()
    if fresh.grid != winner:
        raise AssertionError(f"{label}: a fresh open adopted {fresh.grid}, not {winner}")
    _identical_result(tally(search, fresh, queries, None), default,
                      f"{label} with the adopted grid")
    base = next(r["ms"] for r in report if r["waves"] == 1.0 and r["tile"] is None)
    failed = [r for r in report if "error" in r]
    say(f"  (a) {label}: " + ", ".join(
        f"waves {r['waves']:g} tile {r['tile'] if r['tile'] is not None else 'auto'} "
        + ("skipped" if "skipped" in r else f"{r['ms']:.4f} ms") for r in report)
        + f"; default (waves 1, auto) {base:.4f} ms, winner waves {winner.waves:g} tile "
        f"{winner.tile} at {report[0]['ms'] / base:.3f}x of it; {len(measured)} candidates "
        f"identical to the default, {len(failed)} failed"
        + (f" ({failed[0]['error'][:80]})" if failed else "")
        + f"; persisted and adopted | {card}")
    return {"label": label, "default_ms": base, "winner": winner,
            "ratio": report[0]["ms"] / base, "report": report}


def _p17_tile_cap(card, tally, owner, reopen, queries) -> None:
    """(a) a PQ grid tuned where its tile fits and adopted where it does
    not: tile 32, persisted by ``autotune`` at k = 10 with the bf16 LUT
    (the CLI's defaults), serves a fresh index's search at rerank 400 with
    the f32 LUT (where tile 32 does not fit shared memory) through a
    smaller tile, identical to the default plan; the same tile passed for
    one search still raises."""
    from metrovector_tpu_torch.ops.grid import Grid

    report = owner.autotune(queries=queries, k=10, waves_candidates=(1.0,),
                            tile_candidates=(32,), iters=1, persist=True,
                            exact_lut=False)
    fresh = reopen()
    if fresh.grid != Grid(1.0, 32):
        raise AssertionError(f"tile cap: a fresh open adopted {fresh.grid}, not tile 32")
    want = owner.search(queries, k=10, rerank=RERANK, exact_lut=True, grid=Grid())
    _identical_result(tally(fresh.search, queries, k=10, rerank=RERANK, exact_lut=True),
                      want, "tile cap: the adopted tile 32 at rerank 400, f32 LUT")
    try:
        fresh.search(queries, k=10, rerank=RERANK, exact_lut=True, grid=Grid(1.0, 32))
    except ValueError:
        pass
    else:
        raise AssertionError("tile cap: an explicit tile 32 at rerank 400, f32 LUT ran")
    say(f"  (a) PQIndex sift1m-pq4 tile cap: tile 32 tuned at k 10 with the bf16 LUT "
        f"({report[0]['ms']:.4f} ms), persisted and adopted, serves rerank {RERANK} with "
        f"the f32 LUT identically to the default plan; passed for one search it raises "
        f"| {card}")


def _p17_bucket_kernel(torch, dev, card, idx, queries) -> dict:
    """The bucket kernel itself (IVF-PQ's scan at fetch 400, the bf16 LUT)
    at each waves candidate, by device time, each identical to one wave."""
    from metrovector_tpu_torch import DistanceMetric
    from metrovector_tpu_torch.ops.adc_kernel import fused_adc_topk
    from metrovector_tpu_torch.ops.grid import WAVES, Grid
    from metrovector_tpu_torch.utils.timing import device_ms

    out = {}
    bk = (idx.buckets, idx.bucket_ids, idx.bucket_norms, idx.bucket_fill)
    for bsz, q in queries.items():
        pins = []
        for r in range(10):
            qd = torch.from_numpy(np.roll(q, r, axis=0)).to(dev)
            pins.append((qd, idx._scan_bias(qd, IVF_NPROBE)[0]))

        def run(p, grid):
            return fused_adc_topk(p[0], idx.codes_row, idx._books, idx.rnorms_row,
                                  idx.num_vectors, P17_FETCH, DistanceMetric.L2,
                                  idx.row_valid, False, idx.packed4, p[1], idx.row_bucket,
                                  buckets=bk, grid=grid)

        ref = run(pins[0], None)
        times = {}
        for w in WAVES:
            g = Grid(w)
            _identical(torch, run(pins[0], g), ref, f"bucket kernel batch {bsz} waves {w}")
            times[w] = device_ms(lambda p, g=g: run(p, g), pins, dev)
        times[None] = device_ms(lambda p: run(p, None), pins, dev)
        out[bsz] = times
        say(f"  (a) sift1m-ivfpq4 bucket kernel batch {bsz}, fetch {P17_FETCH}, device ms: "
            + ", ".join(f"waves {w:g} {times[w]:.4f}" for w in WAVES)
            + f"; no grid {times[None]:.4f} | {card}")
    return out


def _cli(args: list[str]) -> subprocess.CompletedProcess:
    here = os.path.dirname(os.path.abspath(__file__))
    return subprocess.run([sys.executable, "-m", "metrovector_tpu_torch"] + args,
                          capture_output=True, text=True, cwd=here, timeout=900)


def _p17_cli(torch, dev, card, tmpdir) -> None:
    """(b) the CLI in subprocesses on the card, all at once: info and
    validate --checksum, search on the dense and the sparse file (JSON
    lines equal to the library's answer), tune --save and tune --index
    --save on copies whose saved hints a fresh Database adopts. The two
    tunings are timed beside four other processes on the card, so the
    grids they save check the round trip only: they are no tuning
    result."""
    from metrovector_tpu_torch import Database, Reader, SearchEngine, SparseSearchEngine
    from metrovector_tpu_torch.ops.grid import Grid

    rng = np.random.default_rng(SEED + 17)
    dense, sparse = P17_FILES["sift"], P17_FILES["sparse1m"]
    qd = os.path.join(tmpdir, "q_dense.npy")
    np.save(qd, rng.integers(0, 256, (16, D_MAIN)).astype(np.float32))
    qs = os.path.join(tmpdir, "q_sparse.npy")
    np.save(qs, _splade_queries(rng, 16))
    tune_dense = os.path.join(tmpdir, "cli_dense.mvt")
    tune_pq = os.path.join(tmpdir, "cli_pq4.mvt")
    shutil.copyfile(dense, tune_dense)
    shutil.copyfile(P17_FILES["sift1m-pq4"], tune_pq)
    jobs = {"info": ["info", dense], "validate": ["validate", dense, "--checksum"],
            "search dense": ["search", dense, "-q", qd, "-k", "10"],
            "search sparse": ["search", sparse, "-q", qs, "-k", "10"],
            "tune": ["tune", tune_dense, "--save"],
            "tune --index": ["tune", tune_pq, "--index", "--save"]}
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(jobs)) as pool:
        runs = dict(zip(jobs, pool.map(_cli, jobs.values())))
    wall = time.perf_counter() - t0
    for name, run in runs.items():
        if run.returncode != 0:
            raise AssertionError(f"CLI {name}: rc {run.returncode}: {run.stderr[-2000:]}")
    if "1 space(s)" not in runs["info"].stdout or \
            runs["validate"].stdout.strip() != "OK (checksums verified)":
        raise AssertionError(f"CLI info/validate: {runs['info'].stdout!r} "
                             f"{runs['validate'].stdout!r}")
    for name, path, q, engine in (
            ("search dense", dense, qd, lambda sp: SearchEngine(sp, device=dev)),
            ("search sparse", sparse, qs, lambda sp: SparseSearchEngine(sp, device=dev))):
        reader = Reader.open(path)
        res = engine(reader.vector_space(reader.vector_space_names[0])).search(
            np.load(q), k=10)
        want = [{"query": qi, "results": [
            {"row": int(i), "id": int(res.ids[qi, j]), "distance": float(res.distances[qi, j])}
            for j, i in enumerate(res.indices[qi]) if i >= 0]} for qi in range(16)]
        got = [json.loads(line) for line in runs[name].stdout.strip().splitlines()]
        if got != want:
            raise AssertionError(f"CLI {name}: its JSON lines differ from the library's")
        del res
    adopted = {}
    for name, path, reopen in (
            ("tune", tune_dense, lambda db: db.engine("sift", mode="exact")),
            ("tune --index", tune_pq, lambda db: db.pq_index("sift"))):
        lines = [json.loads(x) for x in runs[name].stdout.strip().splitlines()]
        applied = lines[-1]
        if not applied.get("saved") or len(lines) < 5:
            raise AssertionError(f"CLI {name}: {lines}")
        grid = reopen(Database.open(path, device=dev)).grid
        if grid != Grid(**applied["applied"]):
            raise AssertionError(f"CLI {name}: a fresh Database adopted {grid}, saved "
                                 f"{applied['applied']}")
        adopted[name] = (grid, len(lines) - 1)
        torch.cuda.empty_cache()
    say(f"  (b) CLI, six subprocesses at once on the card in {wall:.1f} s: info, validate "
        f"--checksum ok; search -k 10 on the dense and the sparse1m files equal to the "
        f"library's answer (16 queries each); " + ", ".join(
            f"{n} --save: {c} candidates, saved waves {g.waves:g} tile {g.tile}, adopted by "
            f"a fresh Database" for n, (g, c) in adopted.items()) + f" | {card}")


def phase_tune_cli(torch, dev, card, sift_path) -> dict:
    """Phase 17 (module docstring). Returns its launches by kernels-line
    name, its reports and its seconds."""
    from metrovector_tpu_torch import (
        IVFPQIndex, PQIndex, Reader, SearchEngine, SparseSearchEngine,
    )

    t_phase = time.perf_counter()
    _keep_for_p17("sift", sift_path)
    tally = _Tally()
    rng = np.random.default_rng(SEED + 17)

    def space(name, key):
        return Reader.open(P17_FILES[key]).vector_space(name)

    def dense_search(owner, q, grid):
        return owner.search(q, k=10) if grid is None else owner._finalize(
            owner._launch(q, 10, grid=grid), 10)

    reports = []
    for label, name, key, q in (
            ("phase 3's 1M x 128 f32", "sift", "sift",
             rng.integers(0, 256, (128, D_MAIN)).astype(np.float32)),
            ("deep10m int8 IP", "deep", "deep10m",
             rng.integers(-128, 128, (128, D_DEEP)).astype(np.float32))):
        def dense(name=name, key=key):
            return SearchEngine(space(name, key), device=dev)

        reports.append(_p17_tune(card, tally, f"SearchEngine, {label}, batch 128, k 10",
                                 dense(), dense, dense_search, q, k=10))
        torch.cuda.empty_cache()

    def pq():
        return PQIndex.from_space(space("sift", "sift1m-pq4"), device=dev)

    owner = pq()
    pq_q = _pq_queries(rng, space("sift", "sift1m-pq4").to_numpy(), 256)
    for label, kw in (("f32 LUT", {"exact_lut": True}), ("int8 LUT", {"int8_lut": True})):
        def pq_search(owner, q, grid, kw=kw):
            return owner.search(q, k=10, rerank=RERANK, grid=grid, **kw)

        reports.append(_p17_tune(
            card, tally, f"PQIndex sift1m-pq4, {label}, batch 256, rerank {RERANK}",
            owner, pq, pq_search, pq_q, k=10, rerank=RERANK, **kw))
        torch.cuda.empty_cache()
    _p17_tile_cap(card, tally, owner, pq, pq_q)

    def ivfpq():
        return IVFPQIndex.from_space(space("sift", "sift1m-ivfpq4"), device=dev)

    def ivf_search(owner, q, grid):
        return owner.search(q, k=10, nprobe=IVF_NPROBE, rerank=P17_FETCH, mode="scan",
                            grid=grid)

    owner = ivfpq()
    ivf_rows = space("sift", "sift1m-ivfpq4").to_numpy()
    ivf_q = {b: _pq_queries(rng, ivf_rows, b) for b in P17_IVF_BATCHES}
    for bsz in P17_IVF_BATCHES:  # the last (256) stays persisted in the copy
        reports.append(_p17_tune(
            card, tally, f"IVFPQIndex sift1m-ivfpq4, scan, batch {bsz}, fetch {P17_FETCH}",
            owner, ivfpq, ivf_search, ivf_q[bsz], k=10, nprobe=IVF_NPROBE,
            rerank=P17_FETCH))
    bucket = _p17_bucket_kernel(torch, dev, card, owner, ivf_q)
    del owner, ivf_rows
    torch.cuda.empty_cache()

    def sparse():
        return SparseSearchEngine(space("splade", "sparse1m"), device=dev)

    reports.append(_p17_tune(
        card, tally, "SparseSearchEngine sparse1m, batch 256, k 10", sparse(), sparse,
        lambda owner, q, grid: owner.search(q, k=10, grid=grid),
        _splade_queries(rng, 256), k=10))
    torch.cuda.empty_cache()
    torch.cuda.synchronize(dev)
    missing = [k for k in P17_KERNELS if not tally.counts.get(k)]
    if missing:
        raise AssertionError(f"phase 17: no launch of {missing} on its main path")
    with tempfile.TemporaryDirectory() as tmpdir:
        _p17_cli(torch, dev, card, tmpdir)
    seconds = time.perf_counter() - t_phase
    say(f"phase 17 autotune and the CLI: ok ({len(reports)} tunings persisted and "
        f"adopted, every candidate identical to the default plan; launches "
        + ", ".join(f"{k} {tally.counts.get(k, 0)}" for k in P17_KERNELS)
        + f"; {seconds:.1f} s) | {card}")
    return {"launches": tally.counts, "reports": reports, "bucket": bucket,
            "seconds": seconds}


# ---------------------------------------------------------------- phase 18 ---

P18_F16 = (1_000_000, 768, 5, 16, 262_144)  # suite.py's stream: n, d, seed, batch, chunk
P18_CHUNKS = (131_072, 100_000)
P18_RUNS = 5
P18_TOMBSTONES = 1_000


def _copy_gbps(torch, dev, nbytes: int) -> float:
    """Pinned-to-device bandwidth of one chunk's ``copy_`` alone, GB/s."""
    from metrovector_tpu_torch.utils.timing import cuda_ms

    host = torch.empty(nbytes, dtype=torch.uint8, pin_memory=True)
    host.fill_(1)
    dst = torch.empty(nbytes, dtype=torch.uint8, device=dev)
    dst.copy_(host, non_blocking=True)
    ms = cuda_ms(lambda _: dst.copy_(host, non_blocking=True), range(5), dev)
    del host, dst
    return nbytes / ms / 1e6


def _p18_case(torch, dev, card, tally, label, space, queries, ks, chunks, filter_mask=None,
              resident=None) -> list[dict]:
    """One streamed case: for each chunk size, batch and k, the streamed
    search identical to the resident ``SearchEngine``'s (each counted
    once), then the streamed wall p50 of P18_RUNS runs after a warm-up,
    the bytes shipped, one chunk's copy bandwidth, the bound (bytes over
    it), the last run's trace (K1's per-chunk CUDA-event times and the
    copies', the share of the copies' time under a scan, the card's busy
    time, the host's fill time), and the resident p50."""
    from metrovector_tpu_torch import SearchEngine, StreamingSearcher

    resident = resident or SearchEngine(space, device=dev)
    rows = []
    for cr in chunks:
        s = StreamingSearcher(space, chunk_rows=cr, device=dev)
        chunk_bytes = s.chunk_rows * space.padded_dim * np.dtype(
            space.padded_array().dtype).itemsize
        gbps = _copy_gbps(torch, dev, chunk_bytes)
        for q in queries:
            for k in ks:
                what = f"{label}, chunk {s.chunk_rows}, batch {q.shape[0]}, k {k}"
                got = tally(s.search, q, k=k, filter_mask=filter_mask)
                ref = tally(resident.search, q, k=k, filter_mask=filter_mask)
                _identical_result(got, ref, what + ": streamed vs resident")
                wall = [sync_time_s(torch, dev, s.search, q, k=k, filter_mask=filter_mask)
                        for _ in range(P18_RUNS)]
                res_p50 = np.median([sync_time_s(torch, dev, resident.search, q, k=k,
                                                 filter_mask=filter_mask)
                                     for _ in range(P18_RUNS)])
                tr, traced = dict(s.last_trace), wall[-1]
                p50 = float(np.median(wall))
                bound = tr["bytes"] / gbps / 1e6
                hidden = tr["hidden"]  # the share of the copies' time under a scan
                idle = 1.0 - tr["card_ms"] / traced
                row = {"label": what, "p50_ms": p50, "bytes": tr["bytes"],
                       "gbps": tr["bytes"] / p50 / 1e6, "copy_gbps": gbps,
                       "bound_ms": bound, "scan_ms": tr["scan_ms"],
                       "copy_ms": tr["copy_ms"], "fill_ms": tr["fill_ms"],
                       "host_ms": tr["host_ms"], "wait_ms": tr["wait_ms"],
                       "traced_ms": traced, "card_ms": tr["card_ms"], "idle": idle,
                       "chunks": tr["chunks"], "resident_ms": float(res_p50),
                       "hidden": hidden}
                rows.append(row)
                say(f"  {what}: identical to resident; streamed p50 {p50:.3f} ms "
                    f"({P18_RUNS} runs), {tr['bytes'] / 1e6:.1f} MB in {tr['chunks']} "
                    f"chunks, {row['gbps']:.2f} GB/s; one chunk's copy_ {gbps:.2f} GB/s, "
                    f"bound {bound:.3f} ms, wall/bound {p50 / bound:.3f}; K1 per-chunk sum "
                    f"{tr['scan_ms']:.3f} ms, copies {tr['copy_ms']:.3f} ms; host fill "
                    f"{tr['fill_ms']:.3f} ms of {tr['host_ms']:.3f} ms busy in the loop, "
                    f"{tr['wait_ms']:.3f} ms waiting on a copy; a scan ran under {hidden:.1%} "
                    f"of the copies' time; the card busy {tr['card_ms']:.3f} ms of the last "
                    f"run's {traced:.3f} ms (idle {idle:.1%}); resident p50 {res_p50:.4f} ms "
                    f"| {card}")
        del s
        torch.cuda.empty_cache()
    return rows


def sync_time_s(torch, dev, fn, *args, **kw) -> float:
    """ms of one call, the device synchronized before and after."""
    torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    fn(*args, **kw)
    torch.cuda.synchronize(dev)
    return (time.perf_counter() - t0) * 1e3


def _p18_f16(torch, dev, card, tally, tmpdir) -> list[dict]:
    """(a) benchmarks/suite.py's stream cell, uncut: 1M x 768 f16 N(0, 1) of
    seed 5 (drawn in row blocks: the same values as one draw), 16 queries,
    k = 10, chunks of 262,144 rows, with the suite's recall gate against a
    float64 oracle over a subsample of 50,000 rows and the answers' rows."""
    from metrovector_tpu_torch import Builder, DataType, Reader

    n, d, seed, nq, chunk = P18_F16
    rng = np.random.default_rng(seed)
    t0 = time.perf_counter()
    data = np.empty((n, d), np.float16)
    for r0 in range(0, n, 100_000):
        data[r0:r0 + 100_000] = rng.standard_normal((min(100_000, n - r0), d))
    path = os.path.join(tmpdir, "stream.mvt")
    b = Builder()
    b.add_vector_space("s", dim=d, dtype=DataType.FLOAT16)
    b.add_vectors("s", data)
    b.build().save(path)
    del b
    _keep_for_p17("stream", path)  # for phase 19
    queries = rng.standard_normal((nq, d)).astype(np.float32)
    say(f"  (a) stream {n}x{d} f16 N(0, 1) (seed {seed}) drawn and written in "
        f"{time.perf_counter() - t0:.1f} s")
    space = Reader.open(path).vector_space("s")
    rows = _p18_case(torch, dev, card, tally, "(a) stream f16", space, [queries], (10,),
                     (chunk,))
    from metrovector_tpu_torch import StreamingSearcher

    res = StreamingSearcher(space, chunk_rows=chunk, device=dev).search(queries, k=10)
    sub = np.unique(np.concatenate([res.indices.ravel(), rng.integers(0, n, 50_000)]))
    x64 = torch.from_numpy(data[sub].astype(np.float64)).to(dev)
    q64 = torch.from_numpy(queries.astype(np.float64)).to(dev)
    dist = (x64 * x64).sum(1)[None, :] - 2.0 * q64 @ x64.T
    want = sub[torch.sort(dist, dim=1, stable=True).indices[:, :10].cpu().numpy()]
    recall = np.mean([len(set(res.indices[i]) & set(want[i])) / 10 for i in range(nq)])
    if recall < 0.99:
        raise AssertionError(f"(a) stream: recall@10 {recall} < 0.99")
    say(f"  (a) stream recall@10 {recall:.4f} against the float64 oracle over "
        f"{sub.size} rows (the suite's gate) | {card}")
    del data, x64, q64, dist
    rows[0]["recall"] = float(recall)
    return rows


def phase_streaming(torch, dev, card, sift_path) -> dict:
    """Phase 18 (module docstring). Returns its launches by kernels-line
    name, its rows and its seconds."""
    from metrovector_tpu_torch import Builder, Reader

    t_phase = time.perf_counter()
    tally = _Tally()
    rng = np.random.default_rng(SEED + 18)
    rows = {}
    with tempfile.TemporaryDirectory() as tmpdir:
        rows["a"] = _p18_f16(torch, dev, card, tally, tmpdir)
        torch.cuda.empty_cache()
        space = Reader.open(sift_path).vector_space("sift")
        qs = [rng.integers(0, 256, (b, D_MAIN)).astype(np.float32) for b in (32, 256)]
        rows["b"] = _p18_case(torch, dev, card, tally, "(b) 1M x 128 f32", space, qs,
                              (10, 100), P18_CHUNKS)
        # (c) the same rows with phase 4's deletion (the top-1 of a query)
        # among 1,000 tombstones, and a filter of phase 4's kind (that row's
        # neighbour) widened to a tenth of the rows
        x = space.to_numpy()
        top1 = int(np.argmin(((x - qs[0][0]) ** 2).sum(1)))
        dead = np.unique(np.concatenate([[top1], rng.choice(N_MAIN, P18_TOMBSTONES - 1,
                                                            replace=False)]))
        path = os.path.join(tmpdir, "sift_tombstoned.mvt")
        b = Builder()
        b.add_vector_space("sift", dim=D_MAIN)
        b.add_vectors("sift", x)
        for r in dead:
            b.delete_vector("sift", int(r))
        b.build().save(path)
        del b, x
        _keep_for_p17("sift_tombstoned", path)  # for phase 19
        keep = rng.random(N_MAIN) >= 0.1
        tomb = Reader.open(path).vector_space("sift")
        rows["c"] = _p18_case(torch, dev, card, tally, "(c) with tombstones and a filter",
                              tomb, qs, (10, 100), P18_CHUNKS, filter_mask=keep)
        torch.cuda.empty_cache()
    deep = Reader.open(P17_FILES["deep10m"]).vector_space("deep")
    rows["d"] = _p18_case(torch, dev, card, tally, "(d) deep10m int8 IP", deep,
                          [rng.integers(-128, 128, (DEEP_BATCH, D_DEEP)).astype(np.float32)],
                          (10,), (None,))
    torch.cuda.empty_cache()
    u8r = Reader.open(P17_FILES["sift1m_u8"])
    q8 = [rng.integers(0, 256, (U8_BATCH, D_MAIN)).astype(np.float32)]
    rows["e"] = _p18_case(torch, dev, card, tally, "(e) sift1m-u8 uint8 L2",
                          u8r.vector_space("u8"), q8, (10,), (None,))
    rows["f"] = _p18_case(torch, dev, card, tally, "(f) uint8 cosine (affine load)",
                          u8r.vector_space("u8cos"), q8, (10,), (None,))
    torch.cuda.empty_cache()
    torch.cuda.synchronize(dev)
    missing = [k for k in P18_KERNELS if not tally.counts.get(k)]
    if missing:
        raise AssertionError(f"phase 18: no launch of {missing} on its main path")
    seconds = time.perf_counter() - t_phase
    say(f"phase 18 streaming: ok (every case identical to the resident search; "
        f"launches " + ", ".join(f"{k} {tally.counts.get(k, 0)}" for k in P18_KERNELS)
        + f"; {seconds:.1f} s) | {card}")
    return {"launches": tally.counts, "rows": rows, "seconds": seconds}


P18_KERNELS = ("fused_topk", "fused_topk[int8]", "fused_topk[affine]")


# ---------------------------------------------------------------- phase 19 ---

P19_SHARDS = 4
P19_RUNS = 5
P19_FILTER = 0.3  # the share of rows the filter of (a) and (e) leaves out
P19_WORKER_TIMEOUT = 300  # seconds a gloo rank may take, start-up included
P19_KERNELS = ("fused_topk", "fused_topk[int8]", "fused_topk[affine]", "fused_adc_topk",
               "fused_adc_topk[int8_mma]", "rescore_candidates", "ell_topk",
               "query_postings")


def _p19_mesh(torch):
    """P19_SHARDS shards: a card each where there are that many cards,
    else all on cuda:0 (an explicit layout: their launches queue on one
    stream)."""
    from metrovector_tpu_torch.parallel import make_mesh

    if torch.cuda.device_count() >= P19_SHARDS:
        return make_mesh(P19_SHARDS)
    return make_mesh(devices=[torch.device("cuda", 0)] * P19_SHARDS)


def _p19_p50(torch, dev, fn, *args, **kw) -> float:
    """p50 ms of P19_RUNS synchronized calls after a warm-up."""
    fn(*args, **kw)
    return float(np.median([sync_time_s(torch, dev, fn, *args, **kw)
                            for _ in range(P19_RUNS)]))


def _p19_case(torch, dev, card, tally, label, sharded, resident, q, k, band=False,
              **kw) -> dict:
    """One sharded search (counted) against the resident one on the same
    batch: identical (``band``: indices and ids identical, scores within 4
    f32 ulps, phase 14's cosine band), then both p50s."""
    got = tally(sharded, q, k=k, **kw)
    ref = tally(resident, q, k=k, **kw)
    if band:
        if not (np.array_equal(got.indices, ref.indices) and np.array_equal(got.ids, ref.ids)
                and np.allclose(got.scores, ref.scores, rtol=4 * 2.0**-24, atol=0)):
            raise AssertionError(f"{label}: outside the band of the resident search")
    else:
        _identical_result(got, ref, label + ": sharded vs resident")
    row = {"label": label, "sharded_ms": _p19_p50(torch, dev, sharded, q, k=k, **kw),
           "resident_ms": _p19_p50(torch, dev, resident, q, k=k, **kw)}
    say(f"  {label}: {'within the band of' if band else 'identical to'} the resident "
        f"search; sharded p50 {row['sharded_ms']:.4f} ms, resident p50 "
        f"{row['resident_ms']:.4f} ms | {card}")
    return row


def _p19_topk_case(torch, dev, card, tally, label, fn, args, ref, ref_p50, ranks_only=False):
    """A low-level sharded top-k ``fn(*args)`` (counted) against the
    resident search's answer ``ref``: indices identical, scores too unless
    ``ranks_only``."""
    s, i = tally(fn, *args)
    if not np.array_equal(i.cpu().numpy(), ref.indices) or (
            not ranks_only and not np.array_equal(s.cpu().numpy(), ref.scores)):
        raise AssertionError(f"{label}: differs from the resident search")
    p50 = _p19_p50(torch, dev, fn, *args)
    say(f"  {label}: {'rank-identical' if ranks_only else 'identical'} to the resident "
        f"search; p50 {p50:.4f} ms, resident p50 {ref_p50:.4f} ms | {card}")
    return {"label": label, "sharded_ms": p50, "resident_ms": ref_p50}


def _p19_split(torch, dev, card, label, whole, shards, inputs) -> dict:
    """Device ms of one call's kernel over every row (``whole``) beside the
    same call as the shards' launches back to back (``shards``), each
    warmed up, the device asleep until the host has queued both calls
    (``utils/timing.py::device_ms``): what splitting the rows costs the
    card, apart from the host. Not main-path launches: not counted."""
    from metrovector_tpu_torch.utils.timing import device_ms

    whole(inputs[0])
    shards(inputs[0])
    w, sh = device_ms(whole, inputs, dev), device_ms(shards, inputs, dev)
    say(f"    {label}: the kernel over every row {w:.4f} ms, the {P19_SHARDS} shards' "
        f"launches {sh:.4f} ms ({sh / w:.2f}x), device time | {card}")
    return {"whole_ms": w, "shards_ms": sh}


def _p19_dense(torch, dev, card, tally, mesh, rng) -> tuple[list, dict]:
    """(a) phase 3's file over the mesh through ShardedDeviceSpace; the
    tombstoned copy of phase 18 with a filter (raw and prepared); the 2-D
    and query meshes and dimension sharding over the same positions.
    Returns the rows and, for (f), the batch and its resident answer."""
    from metrovector_tpu_torch import DistanceMetric, Reader, SearchEngine
    from metrovector_tpu_torch.ops.topk_kernel import fused_topk
    from metrovector_tpu_torch.parallel import (
        ShardedDeviceSpace, dim_sharded_topk, grid_sharded_topk, make_mesh, make_mesh_2d,
        query_sharded_topk, shard_rows,
    )

    L2 = DistanceMetric.L2
    space = Reader.open(P17_FILES["sift"]).vector_space("sift")
    resident = SearchEngine(space, device=dev)
    sds = ShardedDeviceSpace(space, mesh)
    q256 = rng.integers(0, 256, (256, D_MAIN)).astype(np.float32)
    q32 = rng.integers(0, 256, (32, D_MAIN)).astype(np.float32)
    rows = [_p19_case(torch, dev, card, tally, "(a) 1M x 128 f32 L2, 4 shards, batch 256, k 10",
                      sds.search, resident.search, q256, 10),
            _p19_case(torch, dev, card, tally, "(a) batch 32, k 100", sds.search,
                      resident.search, q32, 100)]
    ref = resident.search(q256, k=10)
    ref_p50 = rows[0]["resident_ms"]
    data, norms = resident.space.data, resident.space.norms
    qdev = torch.from_numpy(q256).to(dev)
    per = sds.rows_per_shard
    rows[0].update(_p19_split(
        torch, dev, card, "(a) K1 at batch 256, k 10",
        lambda q: fused_topk(q, data, norms, N_MAIN, 10, L2),
        lambda q: [fused_topk(q, x[:per], n[:per], per, 10, L2)
                   for x, n in zip(sds.data, sds.norms)], [qdev, qdev]))
    grid = make_mesh_2d(2, 2, devices=mesh.devices)  # the same four positions
    g_db, g_norms = shard_rows(data, grid), shard_rows(norms, grid)
    rows.append(_p19_topk_case(torch, dev, card, tally, "(a) grid_sharded_topk on 2 x 2",
                               grid_sharded_topk, (qdev, g_db, g_norms, N_MAIN, 10, L2, grid),
                               ref, ref_p50))
    del g_db, g_norms
    qmesh = make_mesh(devices=mesh.devices, axis="query")
    rows.append(_p19_topk_case(torch, dev, card, tally, "(a) query_sharded_topk on 4",
                               query_sharded_topk, (qdev, data, norms, N_MAIN, 10, L2, qmesh),
                               ref, ref_p50))
    w = D_MAIN // P19_SHARDS
    cols = [data[:, c * w:(c + 1) * w].contiguous() for c in range(P19_SHARDS)]
    qcols = [qdev[:, c * w:(c + 1) * w].contiguous() for c in range(P19_SHARDS)]
    rows.append(_p19_topk_case(torch, dev, card, tally,
                               "(a) dim_sharded_topk on 4 (torch.matmul, TF32 off)",
                               dim_sharded_topk, (qcols, cols, norms, N_MAIN, 10, L2, mesh),
                               ref, ref_p50, ranks_only=True))
    del cols, qcols, resident, sds
    torch.cuda.empty_cache()
    tomb = Reader.open(P17_FILES["sift_tombstoned"]).vector_space("sift")
    res_t, sds_t = SearchEngine(tomb, device=dev), ShardedDeviceSpace(tomb, mesh)
    keep = rng.random(N_MAIN) >= P19_FILTER
    rows.append(_p19_case(torch, dev, card, tally,
                          "(a) 1,000 tombstones and a 30 % filter, 256, k 10", sds_t.search,
                          res_t.search, q256, 10, filter_mask=keep))
    prepared = tally(sds_t.prepare_filter, keep)
    _identical_result(tally(sds_t.search, q256, k=10, filter_mask=prepared),
                      res_t.search(q256, k=10, filter_mask=keep), "(a) prepared filter")
    del res_t, sds_t
    torch.cuda.empty_cache()
    return rows, {"q": q256, "ref": ref, "keep": keep}


def _p19_quantized(torch, dev, card, tally, mesh, rng) -> list:
    """(b) deep10m (int8 IP), sift1m-u8 (uint8 L2) and its uint8 cosine
    space over the mesh: K1's integer route (deferred scale, offset sums)
    and the affine read, each against its resident search."""
    from metrovector_tpu_torch import DistanceMetric, Reader, SearchEngine
    from metrovector_tpu_torch.ops.topk_kernel import fused_topk
    from metrovector_tpu_torch.parallel import ShardedDeviceSpace

    rows = []
    deep = Reader.open(P17_FILES["deep10m"]).vector_space("deep")
    qd = rng.integers(-128, 128, (DEEP_BATCH, D_DEEP)).astype(np.float32)
    sds, resident = ShardedDeviceSpace(deep, mesh), SearchEngine(deep, device=dev)
    rows.append(_p19_case(torch, dev, card, tally, "(b) deep10m int8 IP, batch 128, k 10",
                          sds.search, resident.search, qd, 10))
    prep, d, per = resident.space.prepare_queries(qd), D_DEEP, sds.rows_per_shard
    ip, nv = DistanceMetric.INNER_PRODUCT, resident.space.num_valid
    data, norms = resident.space.data, resident.space.norms
    rows[-1].update(_p19_split(
        torch, dev, card, "(b) K1's integer scan at deep10m, batch 128, k 10",
        lambda q: fused_topk(q, data[:nv, :d], norms[:nv], nv, 10, ip, scale=prep.dot_scale),
        lambda q: [fused_topk(q, x[:per, :d], n[:per], per, 10, ip, scale=prep.dot_scale,
                              raw_scores=True) for x, n in zip(sds.data, sds.norms)],
        [prep.qdev[:, :d]] * 2))
    del sds, resident, data, norms
    torch.cuda.empty_cache()
    u8r = Reader.open(P17_FILES["sift1m_u8"])
    q8 = rng.integers(0, 256, (U8_BATCH, D_MAIN)).astype(np.float32)
    for name, label, band in (("u8", "(b) sift1m-u8 uint8 L2, batch 256, k 10", False),
                              ("u8cos", "(b) uint8 cosine (affine), batch 256, k 10", True)):
        sp = u8r.vector_space(name)
        rows.append(_p19_case(torch, dev, card, tally, label,
                              ShardedDeviceSpace(sp, mesh).search,
                              SearchEngine(sp, device=dev).search, q8, 10, band=band))
        torch.cuda.empty_cache()
    return rows


def _p19_pq(torch, dev, card, tally, mesh, rng) -> list:
    """(c) sharded_pq_topk over phase 8's sift1m-pq4 file (codes, the rows
    for the re-rank, the norms sharded; the codebooks once per device),
    rerank 400, batch 256, f32 LUT then int8 LUT: recall@10 against the
    float64 oracle, indices identical to the plain sharded version on the
    card, p50 beside the resident PQIndex's."""
    from metrovector_tpu_torch import DistanceMetric, PQIndex, Reader
    from metrovector_tpu_torch.parallel import replicate, shard_rows, sharded_pq_topk

    L2 = DistanceMetric.L2
    sp = Reader.open(P17_FILES["sift1m-pq4"]).vector_space("sift")
    books, codes, rnorms = sp.pq_arrays()
    x = np.ascontiguousarray(sp.to_numpy(), np.float32)
    n = x.shape[0]
    dnorms = np.einsum("ij,ij->i", x.astype(np.float64), x.astype(np.float64)).astype(
        np.float32)
    args = (shard_rows(codes, mesh), replicate(books, mesh), shard_rows(rnorms, mesh), n,
            K_PQ, L2, mesh)
    shards = dict(db=shard_rows(x, mesh), db_norms=shard_rows(dnorms, mesh), rerank=RERANK,
                  packed4=True)
    resident = PQIndex.from_space(sp, device=dev)
    x64 = torch.from_numpy(x).to(dev, torch.float64)
    norms64 = (x64 * x64).sum(1)
    q = _pq_queries(rng, x, 256)
    qdev = torch.from_numpy(q).to(dev)
    rows = []
    for lut in ("f32", "int8"):
        kw = dict(shards, exact_lut=lut == "f32", int8_lut=lut == "int8")
        s, i = tally(sharded_pq_topk, qdev, *args, **kw)
        with plain_versions():
            ps, pi = sharded_pq_topk(qdev, *args, **kw)
        if not torch.equal(i, pi):
            raise AssertionError(f"(c) {lut} LUT: differs from the plain sharded version")
        recall = _recall_on_card(torch, x64, norms64, q, i.cpu().numpy(), K_PQ)
        if recall < 0.99:
            raise AssertionError(f"(c) {lut} LUT: recall@10 {recall} < 0.99")
        tally(resident.search, q, k=K_PQ, rerank=RERANK, exact_lut=lut == "f32",
              int8_lut=lut == "int8")
        p50 = _p19_p50(torch, dev, sharded_pq_topk, qdev, *args, **kw)
        r50 = _p19_p50(torch, dev, resident.search, q, k=K_PQ, rerank=RERANK,
                       exact_lut=lut == "f32", int8_lut=lut == "int8")
        label = f"(c) sift1m-pq4 {lut} LUT, rerank 400, batch 256"
        say(f"  {label}: recall@10 {recall:.4f}, identical to the plain sharded version; "
            f"sharded p50 {p50:.4f} ms, resident PQIndex p50 {r50:.4f} ms | {card}")
        rows.append({"label": label, "sharded_ms": p50, "resident_ms": r50,
                     "recall": recall})
    del x64, norms64, resident, args, shards
    torch.cuda.empty_cache()
    return rows


def _p19_sparse(torch, dev, card, tally, mesh, rng) -> list:
    """(d) sparse1m over the mesh (ShardedSparseSearchEngine) against the
    resident SparseSearchEngine at batch 256: identical, f32 near-ties
    excused as in phase 11 (a differing row's exact score within the f32
    band of the k-th)."""
    from metrovector_tpu_torch import DistanceMetric, Reader, SparseSearchEngine
    from metrovector_tpu_torch.ops.sparse_kernel import ell_topk
    from metrovector_tpu_torch.parallel import ShardedSparseSearchEngine

    sp = Reader.open(P17_FILES["sparse1m"]).vector_space("splade")
    sharded, resident = ShardedSparseSearchEngine(sp, mesh), SparseSearchEngine(sp, device=dev)
    q = _splade_queries(rng, 256)
    ip, sh, per = DistanceMetric.INNER_PRODUCT, sharded._shards, sharded.rows_per
    qt = torch.from_numpy(np.ascontiguousarray(q.T)).to(dev)
    split = _p19_split(
        torch, dev, card, "(d) K4 (postings and scan) at sparse1m, batch 256, k 10",
        lambda x: ell_topk(x, resident._cols_ell, resident._vals_ell, None, None, None,
                           resident._norms, SPARSE_N, 10, ip),
        lambda x: [ell_topk(x, c, v, None, None, None, n, per, 10, ip)
                   for c, v, n in zip(sh["cols_ell"], sh["vals_ell"], sh["norms"])],
        [qt, qt])
    got, ref = tally(sharded.search, q, k=10), tally(resident.search, q, k=10)
    if not np.array_equal(got.indices, ref.indices):
        _, fcols, fvals = sp.sparse_csr()
        cols_d = torch.from_numpy(np.array(fcols, np.int32)).to(dev)
        vals_d = torch.from_numpy(np.array(fvals, np.float32)).to(dev)
        if _sparse_recall(torch, cols_d, vals_d, q, got.indices, 10) != 1.0:
            raise AssertionError("(d) sparse1m: differs from the resident search "
                                 "outside the f32 band")
        say("  (d) sparse1m: differs from the resident search only at near-ties")
    p50 = _p19_p50(torch, dev, sharded.search, q, k=10)
    r50 = _p19_p50(torch, dev, resident.search, q, k=10)
    say(f"  (d) sparse1m, 4 shards, batch 256, k 10: sharded p50 {p50:.4f} ms, resident "
        f"p50 {r50:.4f} ms | {card}")
    del sharded, resident, qt
    torch.cuda.empty_cache()
    return [{"label": "(d) sparse1m, batch 256, k 10", "sharded_ms": p50, "resident_ms": r50,
             **split}]


def _p19_stream(torch, dev, card, tally, mesh, rng, dense) -> list:
    """(e) ShardedStreamingSearcher: phase 18's f16 stream file (chunks of
    131,072, 16 queries) and its tombstoned 1M x 128 file with (a)'s
    filter (batch 256), each bit-identical to the resident sharded
    search."""
    from metrovector_tpu_torch import Reader
    from metrovector_tpu_torch.parallel import ShardedDeviceSpace, ShardedStreamingSearcher

    rows = []
    cases = (("stream", "s", "(e) stream 1M x 768 f16, 16 queries, k 10",
              rng.standard_normal((16, P18_F16[1])).astype(np.float32), None),
             ("sift_tombstoned", "sift", "(e) 1M x 128 f32, tombstones and the filter, 256",
              dense["q"], dense["keep"]))
    for key, name, label, q, keep in cases:
        sp = Reader.open(P17_FILES[key]).vector_space(name)
        streamer = ShardedStreamingSearcher(sp, mesh, chunk_rows=P18_CHUNKS[0])
        row = _p19_case(torch, dev, card, tally, label + ", chunks of 131,072",
                        streamer.search, ShardedDeviceSpace(sp, mesh).search, q, 10,
                        filter_mask=keep)
        tr = streamer.last_trace
        say(f"    {tr['chunks']} chunks, {tr['bytes'] / 1e6:.1f} MB; K1 per-chunk sum "
            f"{tr['scan_ms']:.3f} ms, copies {tr['copy_ms']:.3f} ms, host fill "
            f"{tr['fill_ms']:.3f} ms; the card busy {tr['card_ms']:.3f} ms | {card}")
        rows.append(dict(row, chunks=tr["chunks"], bytes=tr["bytes"]))
        del streamer
        torch.cuda.empty_cache()
    return rows


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _p19_rank(argv: list[str]) -> int:
    """One gloo rank of (f), in a process of its own: ``coordinator rank
    path queries.npy out.npz device``. Owns 2 of the 4 shards, both on
    ``device``, checks that they hold exactly its rows, searches the batch
    and writes its answer and p50."""
    import torch

    from metrovector_tpu_torch import Reader
    from metrovector_tpu_torch.parallel import distributed as dist

    coord, rank, path, qpath, out, device = argv
    dist.initialize(coord, 2, int(rank), backend="gloo")
    try:
        dev = torch.device(device)
        mesh = dist.global_mesh(devices=[dev] * (P19_SHARDS // 2))
        space = Reader.open(path).vector_space("sift")
        ds = dist.DistributedSearcher(space, mesh)
        block, per = space.padded_array(), ds.rows_per_shard
        owned = []
        for j, shard in enumerate(ds.data):
            s = mesh.first_shard() + j
            rows = torch.from_numpy(np.ascontiguousarray(block[s * per:(s + 1) * per])).to(dev)
            if not torch.equal(shard[:rows.shape[0]], rows) or shard[rows.shape[0]:].any():
                raise AssertionError(f"rank {rank}: shard {s} is not its own rows")
            owned.append(s)
        q = np.load(qpath)
        res = ds.search(q, k=10)
        p50 = _p19_p50(torch, dev, ds.search, q, k=10)
        np.savez(out, indices=res.indices, scores=res.scores, ids=res.ids,
                 shards=np.asarray(owned), p50=p50)
    finally:
        torch.distributed.destroy_process_group()
    return 0


def _p19_distributed(torch, dev, card, tally, mesh, dense, tmpdir) -> list:
    """(f) DistributedSearcher over phase 3's file: a world of one NCCL
    rank in this process, then two gloo ranks in processes of their own
    on the mesh's first device (cuda:0; 2 of the 4 shards each); every
    answer identical to (a)'s resident one."""
    from metrovector_tpu_torch import Reader
    from metrovector_tpu_torch.parallel import distributed as dist

    rows = []
    space = Reader.open(P17_FILES["sift"]).vector_space("sift")
    # One host: NCCL's bootstrap and gloo's pairs stay on the loopback.
    os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    dist.initialize(f"127.0.0.1:{_free_port()}", 1, 0)
    try:
        backend = torch.distributed.get_backend()
        if backend != "nccl":
            raise AssertionError(f"(f) one rank: backend {backend}, not nccl")
        ds = dist.DistributedSearcher(space, dist.global_mesh(devices=mesh.devices))
        _identical_result(tally(ds.search, dense["q"], k=10), dense["ref"],
                          "(f) NCCL world of one")
        p50 = _p19_p50(torch, dev, ds.search, dense["q"], k=10)
        del ds
    finally:
        torch.distributed.destroy_process_group()
    say(f"  (f) DistributedSearcher, a world of one NCCL rank, 4 shards: identical to "
        f"(a); p50 {p50:.4f} ms | {card}")
    rows.append({"label": "(f) NCCL world of one", "sharded_ms": p50})
    torch.cuda.empty_cache()

    qpath = os.path.join(tmpdir, "p19_queries.npy")
    np.save(qpath, dense["q"])
    coord = f"127.0.0.1:{_free_port()}"
    outs = [os.path.join(tmpdir, f"p19_rank{r}.npz") for r in range(2)]
    t0 = time.perf_counter()
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), "--p19-rank", coord,
                               str(r), P17_FILES["sift"], qpath, outs[r],
                               str(mesh.devices[0])],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(2)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=P19_WORKER_TIMEOUT)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for r, p in enumerate(procs):
        if p.returncode != 0:
            raise AssertionError(f"(f) gloo rank {r} exited {p.returncode}:\n{logs[r][-3000:]}")
    got = [np.load(o) for o in outs]
    if [g["shards"].tolist() for g in got] != [[0, 1], [2, 3]]:
        raise AssertionError("(f) gloo ranks do not own shards 0-1 and 2-3")
    for r, g in enumerate(got):
        if not (np.array_equal(g["indices"], dense["ref"].indices)
                and np.array_equal(g["scores"], dense["ref"].scores)
                and np.array_equal(g["ids"], dense["ref"].ids)):
            raise AssertionError(f"(f) gloo rank {r}: differs from (a)")
    say(f"  (f) DistributedSearcher, two gloo ranks sharing cuda:0 (2 shards each, each "
        f"holding only its rows): both identical to (a); p50 rank 0 "
        f"{float(got[0]['p50']):.4f} ms, rank 1 {float(got[1]['p50']):.4f} ms (the ranks "
        f"search at once on one card); {time.perf_counter() - t0:.1f} s with start-up "
        f"| {card}")
    rows.append({"label": "(f) two gloo ranks", "sharded_ms": float(got[0]["p50"]),
                 "rank1_ms": float(got[1]["p50"])})
    return rows


def phase_sharded(torch, dev, card) -> dict:
    """Phase 19 (module docstring). Returns its launches by kernels-line
    name, its rows and its seconds."""
    t_phase = time.perf_counter()
    tally = _Tally()
    rng = np.random.default_rng(SEED + 19)
    mesh = _p19_mesh(torch)
    say(f"  mesh: {P19_SHARDS} shards on {mesh.cards()} distinct card(s) "
        f"({', '.join(str(d) for d in mesh.devices)})")
    rows = {}
    rows["a"], dense = _p19_dense(torch, dev, card, tally, mesh, rng)
    rows["b"] = _p19_quantized(torch, dev, card, tally, mesh, rng)
    rows["c"] = _p19_pq(torch, dev, card, tally, mesh, rng)
    rows["d"] = _p19_sparse(torch, dev, card, tally, mesh, rng)
    rows["e"] = _p19_stream(torch, dev, card, tally, mesh, rng, dense)
    with tempfile.TemporaryDirectory() as tmpdir:
        rows["f"] = _p19_distributed(torch, dev, card, tally, mesh, dense, tmpdir)
    torch.cuda.synchronize(dev)
    missing = [k for k in P19_KERNELS if not tally.counts.get(k)]
    if missing:
        raise AssertionError(f"phase 19: no launch of {missing} on its main path")
    seconds = time.perf_counter() - t_phase
    say(f"phase 19 sharding: ok (every case identical to its resident search, the "
        f"cosine one within its band; launches "
        + ", ".join(f"{k} {tally.counts.get(k, 0)}" for k in P19_KERNELS)
        + f"; {seconds:.1f} s) | {card}")
    return {"launches": tally.counts, "rows": rows, "seconds": seconds}


# ---------------------------------------------------------------- phase 20 ---

P20_EXAMPLES = ("simple", "data_types", "similarity_search", "online_updates",
                "quantized_search", "sparse_and_filtered", "serving", "sharded_search",
                "multihost")
P20_ARGS = {"sharded_search": ["--shards", "4"]}
P20_LARGE = ["--size", "2.5"]  # the reference's default: 873,813 x 768 f32
P20_DRYRUN = 4
P20_WORKER_TIMEOUT = 300  # seconds the CPU run of the examples may take
P20_THREADS = 4  # the CPU run's threads: it shares the host with the card run
# Card against CPU: the printed L2 values within one unit of their last
# digit (an f32 ulp of the expanded form may round either way); the PQ and
# IVF-PQ lines within a band, since their codebooks and quantizer are
# trained by k-means on the card, whose float sums run in another order
# than the host's: recalls and MB within 0.05, the scan mode's agreement
# within 5 points. Every other character of every line identical.
P20_BAND = (0.05, 5)
# Integer answers held identical, but for the IVF index that
# similarity_search trains on the card (its k-means, as above).
P20_TRAINED = ("similarity_search/ivf",)
P20_KERNELS = ("fused_topk", "fused_topk[int8]", "fused_adc_topk",
               "fused_adc_topk[group_bias]", "rescore_candidates", "ell_topk",
               "query_postings")


def _answer_lines():
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "examples"))
    import _answer_lines

    return _answer_lines


def _int_answers(out, prefix: str) -> dict:
    """Every integer array in an example's returned answers, by key path."""
    found = {}
    if isinstance(out, dict):
        items = out.items()
    elif isinstance(out, (list, tuple)):
        items = enumerate(out)
    else:
        return found
    for key, value in items:
        path = f"{prefix}/{key}"
        if isinstance(value, np.ndarray) and value.dtype.kind in "iu":
            found[path] = value
        else:
            found.update(_int_answers(value, path))
    return found


def _p20_cpu(out_path: str) -> int:
    """The examples of phase 20 with ``--device cpu`` (the kernels' plain
    versions), in a process of its own: their printed lines, integer
    answers and walls, written to ``out_path`` as JSON."""
    import torch

    torch.set_num_threads(P20_THREADS)
    lines = _answer_lines()
    runs = {}
    for name in P20_EXAMPLES:
        t0 = time.perf_counter()
        out, printed = lines.captured(lines.load("torch_" + name).main,
                                      ["--device", "cpu", *P20_ARGS.get(name, [])])
        runs[name] = {"lines": printed, "wall": time.perf_counter() - t0,
                      "answers": {k: v.tolist() for k, v in _int_answers(out, name).items()}}
    with open(out_path, "w") as f:
        json.dump(runs, f)
    return 0


def _p20_large(torch, dev, card, tally, lines) -> dict:
    """``large_dataset --size 2.5`` on the card: its top-10 held to
    ``fused_topk_reference`` on the same tensors (phase 2's rule for float
    data) and its recall to a float64 oracle on the card."""
    from metrovector_tpu_torch import DistanceMetric
    from metrovector_tpu_torch.ops.topk_kernel import fused_topk_reference
    from metrovector_tpu_torch.utils import device_trace

    t0 = time.perf_counter()
    _zero_counts()
    out, printed = lines.captured(lines.load("torch_large_dataset").main, P20_LARGE)
    tally.add()
    wall = time.perf_counter() - t0
    sp, q = out["engine"].space, out["queries"]
    n, d = out["shape"]
    qd = torch.zeros((q.shape[0], sp.data.shape[1]), device=dev)  # padded as stored
    qd[:, :d] = torch.from_numpy(q).to(dev)
    ref = fused_topk_reference(qd, sp.data, sp.norms, n, 10, DistanceMetric.L2)
    x64 = sp.data[:n, :d].double()
    norms64 = (x64 * x64).sum(1)
    exact = (2.0 * (qd[:, :d].double() @ x64.T) - norms64[None, :]).cpu().numpy()
    tol = 4 * d * 2.0**-24 * np.linalg.norm(q, axis=1) * float(norms64.max().sqrt())
    got = (torch.from_numpy(out["scores"]), torch.from_numpy(out["indices"]))
    err = _compare(got, ref, False, tol, exact, "large_dataset top-10 vs plain")
    recall = _recall_on_card(torch, x64, norms64, q, out["indices"], 10)
    del x64, norms64, exact
    with tempfile.TemporaryDirectory() as tdir:  # one more search, traced (not counted)
        with device_trace(tdir, device=dev) as path:
            with torch.profiler.record_function("p20_search"):
                out["engine"].search(q, k=10)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    on_card = sorted((e for e in events if e.get("cat") == "kernel"),
                     key=lambda e: -e.get("dur", 0))
    if not on_card or not any(e.get("name") == "p20_search" for e in events):
        raise AssertionError("device_trace recorded no kernel on the card or no span")
    del out
    torch.cuda.empty_cache()
    if recall < 0.99:
        raise AssertionError(f"large_dataset: recall@10 {recall:.4f} below 0.99")
    report = printed[next(i for i, line in enumerate(printed)
                          if line.startswith("fused search")):]
    say(f"  large_dataset {' '.join(P20_LARGE)} ({n:,} x {d} f32, {n * d * 4 / 1e9:.2f} GB on the "
        f"card): top-10 of {q.shape[0]} queries within the band of fused_topk_reference "
        f"(max |diff| {err:.3g}), recall@10 {recall:.4f} against the float64 oracle; "
        f"wall {wall:.1f} s | {card}")
    for line in report:
        if line.strip():
            say("    " + line)
    say(f"  device_trace of one more search: {len(on_card)} kernels on the card, the "
        f"longest " + ", ".join(f"{e['name'][:48]} {e['dur'] / 1e3:.4f} ms"
                                for e in on_card[:2]) + f" | {card}")
    return {"wall": wall, "recall": recall, "max_err": err}


def phase_examples(torch, dev, card) -> dict:
    """Phase 20 (module docstring). Returns its launches by kernels-line
    name, the walls and its seconds."""
    from metrovector_tpu_torch.parallel.dryrun import dryrun_multichip

    t_phase = time.perf_counter()
    lines = _answer_lines()
    tally = _Tally()
    with tempfile.TemporaryDirectory() as tmpdir:
        cpu_out = os.path.join(tmpdir, "p20_cpu.json")
        cpu = subprocess.Popen([sys.executable, os.path.abspath(__file__), "--p20-cpu",
                                cpu_out], stdout=subprocess.PIPE,
                               stderr=subprocess.STDOUT, text=True)
        try:
            runs = {}
            for name in P20_EXAMPLES:
                argv = {"sharded_search": ["--device", f"cuda:{dev.index}"]}.get(name, [])
                t0 = time.perf_counter()
                _zero_counts()
                out, printed = lines.captured(lines.load("torch_" + name).main,
                                              argv + P20_ARGS.get(name, []))
                tally.add()
                runs[name] = {"lines": printed, "wall": time.perf_counter() - t0,
                              "answers": _int_answers(out, name)}
                del out
            torch.cuda.synchronize(dev)
            large = _p20_large(torch, dev, card, tally, lines)
            t0 = time.perf_counter()
            _zero_counts()
            with contextlib.redirect_stdout(sys.stderr):
                dry = dryrun_multichip(P20_DRYRUN, device="cuda")
            tally.add()
            dry_wall = time.perf_counter() - t0
            log = cpu.communicate(timeout=P20_WORKER_TIMEOUT)[0]
        finally:
            if cpu.poll() is None:
                cpu.kill()
                cpu.communicate()
        if cpu.returncode != 0:
            raise AssertionError(f"the examples' CPU run exited {cpu.returncode}:\n"
                                 f"{log[-3000:]}")
        with open(cpu_out) as f:
            host = json.load(f)
    loose = ((r"L2=", lines.ULP), (r"^pq m=|^ivfpq nprobe=", P20_BAND))
    for name in P20_EXAMPLES:
        bad = lines.compare(runs[name]["lines"], host[name]["lines"], loose)
        if bad:
            raise AssertionError(f"{name}: the card's lines differ from the CPU's: {bad}")
        same = not lines.compare(runs[name]["lines"], host[name]["lines"])
        want = host[name]["answers"]
        got = runs[name]["answers"]
        if set(got) != set(want):
            raise AssertionError(f"{name}: answers {sorted(got)} against {sorted(want)}")
        for key, value in got.items():
            if key not in P20_TRAINED and value.tolist() != want[key]:
                raise AssertionError(f"{name}: {key} differs between the card and the CPU")
        say(f"  {name}: answers on the card equal the CPU's (printed lines "
            f"{'identical' if same else 'within the band'}); wall {runs[name]['wall']:.2f} "
            f"s on the card, {host[name]['wall']:.2f} s on the CPU | {card}")
    say(f"  dryrun_multichip({P20_DRYRUN}) on {', '.join(dry['devices'])}: "
        f"{len(dry['checks'])} checks ok ({', '.join(dry['checks'])}); {dry_wall:.1f} s "
        f"| {card}")
    missing = [k for k in P20_KERNELS if not tally.counts.get(k)]
    counts = ", ".join(f"{k} {v}" for k, v in sorted(tally.counts.items()) if v)
    if missing:
        raise AssertionError(f"phase 20: no launch of {missing} on its main path ({counts})")
    seconds = time.perf_counter() - t_phase
    say(f"phase 20 examples: ok ({len(P20_EXAMPLES)} examples on the card equal to the "
        f"CPU, large_dataset at full width, the dry run on {P20_DRYRUN} shards; launches "
        f"{counts}; {seconds:.1f} s) | {card}")
    return {"launches": tally.counts, "large": large, "seconds": seconds,
            "walls": {name: runs[name]["wall"] for name in P20_EXAMPLES}}


def time_parent(parent: str, files: str, card: str) -> None:
    """K1-K4 of another checkout (the parent commit, unpacked by the caller)
    at the kernels-line points, and its search() p50 on this run's dense
    and PQ files (in ``files``; on the PQ files also with the int8 LUT, and
    K2's own time with the int8 and the bf16 LUT), each in a process of its own
    (tools/scan_kernel_timing.py), beside this one's in the same process
    layout: parent, this tree, this tree, parent with the kernels, then
    three more pairs of search() alone in alternating order; the p50s'
    medians and spreads (lowest, highest) close the comparison."""
    here = os.path.dirname(os.path.abspath(__file__))
    tool = os.path.join(here, "tools", "scan_kernel_timing.py")
    t0 = time.perf_counter()
    parent = os.path.abspath(parent)
    p50 = {parent: {}, here: {}}
    order = [(parent, True), (here, True), (here, True), (parent, True),
             (parent, False), (here, False), (here, False), (parent, False),
             (parent, False), (here, False)]
    for root, kernels in order:
        run = subprocess.run([sys.executable, tool, "--root", root, "--files", files]
                             + ([] if kernels else ["--kernels", "none"]),
                             capture_output=True, text=True, timeout=600)
        if run.returncode != 0:
            raise RuntimeError(f"timing {root} failed: {run.stderr[-2000:]}")
        got = json.loads(run.stdout.strip().splitlines()[-1])
        for point, ms in got["e2e"].items():
            p50[root].setdefault(point, []).append(ms)
        if not kernels:
            continue
        say(f"  {'parent' if root != here else 'this tree'} ({root}): K1 " + ", ".join(
            f"batch={p.split(',')[0]} k={p.split(',')[1]} {v:.4f} ms"
            for p, v in got["k1"].items())
            + " | K2 k=400 " + ", ".join(f"{p} {v:.4f} ms" for p, v in got["k2"].items())
            + " | K3 " + ", ".join(
                f"{p} device {v['device_ms']:.4f} ms, per call {v['call_ms']:.4f}, host "
                f"{v['host_us']:.1f} us" + (f", index_select {v['index_select_ms']:.4f}"
                                            if "index_select_ms" in v else "")
                for p, v in got["k3"].items())
            + " | K4 ell_topk k=10 " + ", ".join(
                f"batch={p} {v:.4f} ms" for p, v in got["k4"].items())
            + " | K1 variants " + ", ".join(
                f"{p} {v:.4f} ms" for p, v in got.get("k1v", {}).items())
            + " | search() p50 " + ", ".join(
                f"{p} {v:.4f} ms" for p, v in got["e2e"].items()) + f" | {card}")
    for point in p50[here]:
        a, b = (np.array(p50[r][point]) for r in (parent, here))
        what = "K2 k=400 by CUDA events" if "K2" in point else "search() p50"
        say(f"  {what} {point}, {len(a)} processes each: parent median "
            f"{np.median(a):.4f} ms ({a.min():.4f}-{a.max():.4f}), this tree "
            f"{np.median(b):.4f} ({b.min():.4f}-{b.max():.4f}) | {card}")
    say(f"  timing both checkouts took {time.perf_counter() - t0:.1f} s")


def main() -> int:
    import torch

    if len(sys.argv) == 8 and sys.argv[1] == "--p19-rank":  # phase 19's gloo ranks
        return _p19_rank(sys.argv[2:])
    if len(sys.argv) == 3 and sys.argv[1] == "--p20-cpu":  # phase 20's CPU run
        return _p20_cpu(sys.argv[2])
    parent = None
    if len(sys.argv) == 3 and sys.argv[1] == "--parent":
        parent = sys.argv[2]
    elif len(sys.argv) != 1:
        print("usage: python3 chip_smoke.py [--parent DIR]", file=sys.stderr)
        return 2
    card_name, card = phase_device(torch)
    dev = torch.device("cuda", 0)
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "tools"))
    counters = phase_build()
    return _main(torch, card_name, card, dev, parent, counters)


def _main(torch, card_name, card, dev, parent, counters) -> int:
    global P17_DIR
    # Phases 17 and 18 tune and stream copies of earlier phases' files.
    p17_dir = tempfile.TemporaryDirectory()
    P17_DIR = p17_dir.name
    # With --parent, the dense and PQ files stay for the parent's search().
    keep = tempfile.TemporaryDirectory() if parent is not None else None
    keep_dir = keep.name if keep is not None else None
    max_err, _ = phase_kernel_vs_plain(torch, dev)
    engine, tmp, launches, times = phase_main_path(torch, dev, card, keep_dir)
    # The phase 3 file stays for phase 13.
    sift_path = os.path.join(keep_dir or tmp.name, "sift1m_like.mvt")
    try:
        phase_filters_ids(torch, engine)
        phase_serving(engine)
        adc_err, _ = phase_adc_vs_plain(torch, dev)
        gather_err, rescore_err = phase_gather_vs_plain(torch, dev)
        pq_launches, pq_times, pq4, pq8 = phase_pq_path(torch, dev, card, keep_dir)
        phase_any_k(torch, dev, card, engine, pq4)
        dense = engine.space  # the phase 3 corpus stays for phase 15
        del engine  # phase 8's pq4 index stays for phase 14
        torch.cuda.empty_cache()
        sparse_err, dots_err = phase_sparse_vs_plain(torch, dev)
        sparse_launches, sparse_times = phase_sparse_path(torch, dev, card)
        group_err, group_launches, ivf_cell, ivf_keep = phase_ivfpq_path(torch, dev, card)
        torch.cuda.empty_cache()
        high = phase_high_path(torch, dev, card, sift_path)
        torch.cuda.empty_cache()
        quant = phase_quantized(torch, dev, card, sift_path, pq4)
        quant16 = quant.pop("keep16")  # phase 14's spaces, for phase 16
        pq4_idx = pq4[0]
        del pq4
        lookup = pq_times["int8_lookup"]
        quant["int8_lut"] = {"launches": lookup["launches"], "max_err": 0.0,
                             **{k: lookup["cell"][256][k] for k in ("ms", "plain_ms", "bound")}}
        torch.cuda.empty_cache()
        quant.update(phase_presampled(torch, dev, card, dense, quant.pop("keep"),
                                      high.pop("keep"), ivf_keep, counters))
        torch.cuda.empty_cache()
        p16 = phase_mutation(torch, dev, card, sift_path, dense, quant16, pq4_idx, pq8,
                             ivf_keep["idx"])
        del dense, ivf_keep, pq4_idx, pq8, quant16
        torch.cuda.empty_cache()
        p17 = phase_tune_cli(torch, dev, card, sift_path)
        torch.cuda.empty_cache()
        p18 = phase_streaming(torch, dev, card, sift_path)
        torch.cuda.empty_cache()
        p19 = phase_sharded(torch, dev, card)
        torch.cuda.empty_cache()
        p20 = phase_examples(torch, dev, card)
    finally:
        tmp.cleanup()
        p17_dir.cleanup()

    # The kernels line: each kernel at the main path's timed point, its
    # bound from this run's shapes (module docstring).
    kms, pms = times[(256, 10)]
    main_cell = pq_times[(PQ_CONFIGS[0][0], 256)]
    n, d, q = N_MAIN, D_MAIN, 256
    k1_bound = bound(2 * q * n * d, 4 * (n * d + n + q * d) + 8 * q * 10)
    # K2's adds are f32 instructions: 33.5 T/s, half the 67 TFLOP/s that
    # counts an FMA as two operations, so each add counts 2.
    k2_bound = bound(2 * q * n * 32, n * 16 + 4 * n + 4 * q * 32 * 16 + 8 * q * 400)
    lookup_figures(torch, q * n * 32, card)
    rows = q * RERANK
    k3_bound = bound(2 * rows * d, 4 * rows * d + 4 * rows + 4 * q * d + 8 * q * K_PQ)
    g_bound = bound(0, 2 * 4 * rows * d + 4 * rows)  # int32 indices, as K2 gives
    # K4 does the products of the queries' nonzeros only: its operations
    # are 2 x those multiply-adds, counted on the timed batch; its bytes the
    # ELL arrays, qt, the norms and the outputs, each once.
    n_pad = -(-SPARSE_N // 8192) * 8192
    s_row = sparse_times[256]
    ell_bytes = n_pad * SPARSE_NNZ * 8 + 4 * SPARSE_DIM * q
    topk_bound = bound(2 * s_row["macs_topk"], ell_bytes + 4 * n_pad + 8 * q * 10)
    dots_bound = bound(2 * s_row["macs_dots"], ell_bytes + 4 * n_pad * q)
    post_bound = bound(0, 4 * SPARSE_DIM * q + 8 * s_row["nnz"] + 4 * (SPARSE_DIM + 1))
    dense_bound = bound(2 * SPARSE_N * SPARSE_NNZ * q, ell_bytes + 4 * n_pad)
    say(f"  K4 bounds at sparse1m batch 256: ell_topk {topk_bound[0]:.4f} ms "
        f"({topk_bound[1]}; {s_row['macs_topk']} nonzero multiply-adds), ell_dots "
        f"{dots_bound[0]:.4f} ms ({dots_bound[1]}); the dense-FLOP reckoning of "
        f"earlier runs (2 N 48 Q) gave {dense_bound[0]:.4f} ms ({dense_bound[1]})")
    r32 = sparse_times[32]
    b32 = n_pad * SPARSE_NNZ * 8 + 4 * SPARSE_DIM * 32
    t32 = bound(2 * r32["macs_topk"], b32 + 4 * n_pad + 8 * 32 * 10)
    d32 = bound(2 * r32["macs_dots"], b32 + 4 * n_pad * 32)
    say(f"  K4 bounds at sparse1m batch 32: ell_topk {t32[0]:.4f} ms ({t32[1]}; "
        f"{r32['macs_topk']} nonzero multiply-adds), ell_dots {d32[0]:.4f} ms "
        f"({d32[1]}); shares ell_topk {t32[0] / r32['ell_topk']:.1%}, ell_dots "
        f"{d32[0] / r32['ell_dots']:.1%}")
    if parent is not None:
        try:
            time_parent(parent, keep_dir, card)
        finally:
            keep.cleanup()
    kernels = [
        {"name": "fused_topk", "route": "cuda", "source": KERNEL_SOURCE,
         "replaces": KERNEL_REPLACES, "launches": launches,
         "max_abs_err": max_err, "ms": kms, "plain_ms": pms,
         "bound_ms": k1_bound[0], "bound_by": k1_bound[1], "library_ms": None},
        {"name": "fused_adc_topk", "route": "cuda",
         "source": CSRC + "adc_kernel.cu",
         "replaces": "metrovector_tpu/ops/adc_kernel.py:248",
         "launches": pq_launches["fused_adc_topk"], "max_abs_err": adc_err,
         "ms": main_cell["k2"][0], "plain_ms": main_cell["k2"][1],
         "bound_ms": k2_bound[0], "bound_by": k2_bound[1], "library_ms": None},
        {"name": "gather_rows", "route": "cuda",
         "source": CSRC + "gather_kernel.cu",
         "replaces": "metrovector_tpu/ops/gather_kernel.py:137",
         "launches": pq_launches["gather_rows"], "max_abs_err": gather_err,
         "ms": main_cell["gather"][0], "plain_ms": main_cell["gather"][1],
         "bound_ms": g_bound[0], "bound_by": g_bound[1],
         "library_ms": main_cell["gather_library"]},
        {"name": "rescore_candidates", "route": "cuda",
         "source": CSRC + "gather_kernel.cu",
         "replaces": "metrovector_tpu/ops/gather_kernel.py:137",
         "launches": pq_launches["rescore_candidates"],
         "max_abs_err": rescore_err,
         "ms": main_cell["k3"][0], "plain_ms": main_cell["k3"][1],
         "bound_ms": k3_bound[0], "bound_by": k3_bound[1], "library_ms": None},
        {"name": "ell_topk", "route": "cuda", "source": CSRC + "sparse_kernel.cu",
         "replaces": "benchmarks/sparse_vmem_proto.py:87",
         "launches": sparse_launches["ell_topk"], "max_abs_err": sparse_err,
         "ms": s_row["ell_topk"], "plain_ms": s_row["plain"],
         "bound_ms": topk_bound[0], "bound_by": topk_bound[1],
         "library_ms": None},
        {"name": "query_postings", "route": "cuda",
         "source": CSRC + "sparse_kernel.cu",
         "replaces": "benchmarks/sparse_vmem_proto.py:87",
         "launches": sparse_launches["query_postings"],
         "max_abs_err": max(sparse_times[b]["post_err"] for b in (256, 32)),
         "ms": s_row["postings"], "plain_ms": s_row["postings_plain"],
         "bound_ms": post_bound[0], "bound_by": post_bound[1],
         "library_ms": None},
        {"name": "fused_adc_topk[group_bias]", "route": "cuda",
         "source": CSRC + "adc_bucket_kernel.cu",
         "replaces": "metrovector_tpu/ops/adc_kernel.py:248",
         "launches": group_launches, "max_abs_err": group_err,
         "ms": ivf_cell["ms"], "plain_ms": ivf_cell["plain_ms"],
         "bound_ms": ivf_cell["bound"][0], "bound_by": ivf_cell["bound"][1],
         "bound_all_rows_ms": ivf_cell["bound_rows"][0],
         "bound_all_rows_by": ivf_cell["bound_rows"][1], "library_ms": None},
        {"name": "fused_topk[high]", "route": "cuda", "source": HIGH_SOURCE,
         "replaces": KERNEL_REPLACES, "launches": high["launches"],
         "max_abs_err": high["max_err"], "ms": high["ms"],
         "plain_ms": high["plain_ms"], "bound_ms": high["bound"][0],
         "bound_by": high["bound"][1], "library_ms": None},
        {"name": "ell_dots", "route": "cuda", "source": CSRC + "sparse_kernel.cu",
         "replaces": "benchmarks/sparse_vmem_proto.py:87",
         "launches": sparse_launches["ell_dots"], "max_abs_err": dots_err,
         "ms": s_row["ell_dots"], "plain_ms": s_row["dots_plain"],
         "bound_ms": dots_bound[0], "bound_by": dots_bound[1],
         "library_ms": s_row["library"]},
    ] + [
        {"name": name, "route": "cuda", "source": source, "replaces": replaces,
         "launches": quant[key]["launches"], "max_abs_err": quant[key]["max_err"],
         "ms": quant[key]["ms"], "plain_ms": quant[key]["plain_ms"],
         "bound_ms": quant[key]["bound"][0], "bound_by": quant[key]["bound"][1],
         "library_ms": None}
        for name, key, source, replaces in (
            ("fused_topk[int8]", "int8", INT_SOURCE, KERNEL_REPLACES),
            ("fused_topk[affine]", "affine", KERNEL_SOURCE, KERNEL_REPLACES),
            ("fused_adc_topk[int8_mma]", "int8_mma", CSRC + "adc_int8_mma_kernel.cu",
             "metrovector_tpu/ops/adc_kernel.py:248"),
            ("fused_adc_topk[int8_lut]", "int8_lut", CSRC + "adc_int8_kernel.cu",
             "metrovector_tpu/ops/adc_kernel.py:248"),
            ("fused_topk_presampled", "presampled", KERNEL_SOURCE,
             "metrovector_tpu/ops/topk_kernel.py:1040"),
            ("fused_adc_topk[group_rows]", "group_rows", CSRC + "adc_bucket_kernel.cu",
             "metrovector_tpu/ops/adc_kernel.py:248"))
    ]
    for row in kernels:  # each path's launches: phases 3-15, then 16's to 20's
        row["launches"] += sum(p["launches"].get(row["name"], 0)
                               for p in (p16, p17, p18, p19, p20))
    say(json.dumps({"kernels": kernels}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": card_name,
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
