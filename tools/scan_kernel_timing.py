#!/usr/bin/env python3
"""Time the scan-and-select kernels of one checkout of the port on one
NVIDIA GPU, on inputs made on the card from fixed seeds.

    python3 tools/scan_kernel_timing.py [--root DIR] [--define FLAG ...]
                                        [--profile]
                                        [--kernels k1,k1v,k1bf16,k2,k2i8,k3,k4]
                                        [--files DIR] [--turns DIR] [--out FILE]

``--root`` names the checkout whose ``metrovector_tpu_torch`` is imported
and built (default: this one), so that two commits can be timed in one
call on one card, each in a process of its own: ``chip_smoke.py`` times the
parent commit's tree this way beside this one's. ``--define`` appends a
``-D`` flag to the kernels' build (a variant builds beside the default one:
the flags are part of the build directory's hash). ``--turns DIR`` times
the kernels asked for in four processes, DIR's checkout, this one, this one
and DIR's again, and prints each run's JSON and then their medians.

Points (the kernels-line points of ``chip_smoke.py``):

* ``fused_topk`` (K1) over 1M x 128 integer-valued f32 rows, L2: batch
  256, 128 and 32 at k=10, batch 32 at k=100; beside it one ``torch.mm`` of
  the batch-256 product in full f32 (TF32 off), a yardstick for the scan
  alone (it selects nothing);
* K1's tensor-core variants (``k1v``, kernels ``scan_kernel<S8Op, NW>``
  and ``high_scan_kernel``, the latter after ``split_queries_kernel``): the
  integer scan over 10M random int8 rows of 96 codes stored 128 bytes a
  row (``deep10m``'s shape: inner product, deferred scale 0.02, k=10) at
  batches 128 and 32, beside ``torch._int_mm`` of the batch-128 product
  on the padded rows, and over 1M random rows of 128 codes in the uint8
  offset form (``sift1m-u8``'s: L2, scale 128/127 and the row sums as
  ``bias_row``) at batch 256; the bf16x3 scan over 1M x 960 N(0, 1) rows
  (``gist1m``'s: cosine, unit queries, k=18) at batches 256 and 64, and
  over the K1 corpus at batch 32, k=10, beside K1 ``highest`` there;
* K1 over bf16 rows (``k1bf16``): the K1 corpus as bf16 (L2, k=10) at
  batches 256 and 32 and 1M x 960 N(0, 1) bf16 rows (cosine, unit
  queries, k=10) at batch 256, with queries rounded to bf16, as a BFLOAT16
  space hands them over. A checkout with ``precision="default"`` runs the
  one-pass scan's bf16 instance (``scan_kernel<Bf16Op, NW>``); one without
  it runs the FFMA kernel over the same rows and queries, which is what it
  runs for a BFLOAT16 space (``k1bf16_route`` names which);
* ``fused_adc_topk`` (K2) at k=400, L2, f32 LUT, over 1M random codes:
  4-bit m=32 (nibble-packed) and 8-bit m=16, batches 256 and 32;
* K2's int8 LUT (``k2i8``) at the same points (random norms), beside the
  bf16 LUT: the tensor-core product at pq4 (``int8_mma_kernel``), the
  lookup scan at pq8 (``adc_scan_kernel``);
* ``ell_topk`` (K4) at ``sparse1m`` shape (1M rows x 48 entries over
  30,522 terms, queries of 256 nonzeros), k=10, batches 256 and 32;
* ``rescore_candidates`` (K3) over the K1 corpus, R=400, k=10, L2, batches
  256 and 32, with int32 candidate rows as K2 hands them (a few -1), and
  ``gather_rows`` of those candidates (102,400 and 12,800 int32 indices,
  and the same as int64) beside ``torch.index_select`` on the same
  indices. K3 is shorter
  than its launch on the host, so each point records its device time
  (``device_ms``: the device sleeps first, so the host has queued every
  call before the first event), its per-call time (``cuda_ms``, which
  times the host where the host is slower) and the host microseconds per
  wrapper call.

CUDA-event times over back-to-back calls on distinct inputs after one
warm-up call. ``--files DIR`` also times ``search()`` p50 on the dense and
PQ files that ``chip_smoke.py --parent`` leaves there (:func:`search_p50`). ``--profile`` adds device time by kernel name
(``torch.profiler``). The last line of the output is one JSON object.
Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

N, D = 1_000_000, 128
K1_POINTS = ((256, 10), (128, 10), (32, 10), (32, 100))
K1V_INT_N, K1V_INT_D, K1V_INT_WIDTH, K1V_GIST_D = 10_000_000, 96, 128, 960
K2_POINTS = (("pq4", 32, 16, True), ("pq8", 16, 256, False))
K2_K, K2_BATCHES = 400, (256, 32)
K3_R, K3_K, K3_BATCHES = 400, 10, (256, 32)
SP_DIM, SP_NNZ, SP_QNNZ = 30_522, 48, 256
ITERS = 10


def _by_kernel(prof, calls: int) -> dict:
    return {ev.key.replace("void ", "").replace("(anonymous namespace)::", "")
            .split("(")[0].split("<")[0]: ev.device_time_total / 1e3 / calls
            for ev in prof.key_averages() if ev.device_time_total > 0}


def measure(profile: bool, kernels: set[str]) -> dict:
    import torch
    from torch.profiler import ProfilerActivity, profile as torch_profile

    from metrovector_tpu_torch import DistanceMetric
    from metrovector_tpu_torch.ops import _build
    from metrovector_tpu_torch.ops.adc_kernel import fused_adc_topk
    from metrovector_tpu_torch.ops.gather_kernel import gather_rows, rescore_candidates
    from metrovector_tpu_torch.ops.sparse_kernel import ell_topk
    from metrovector_tpu_torch.ops.topk_kernel import fused_topk
    from metrovector_tpu_torch.utils.timing import cuda_ms, device_ms

    torch.backends.cuda.matmul.allow_tf32 = False
    _build.load()
    dev = torch.device("cuda", 0)
    l2, ip = DistanceMetric.L2, DistanceMetric.INNER_PRODUCT
    g = torch.Generator(device=dev)
    g.manual_seed(7)
    out = {"k1": {}, "k1v": {}, "k1bf16": {}, "k2": {}, "k2i8": {}, "k3": {}, "k4": {},
           "by_kernel": {}}

    def timed(name, fn, inputs):
        fn(inputs[0])
        torch.cuda.synchronize()
        ms = cuda_ms(fn, inputs, dev)
        if profile:
            with torch_profile(activities=[ProfilerActivity.CUDA]) as prof:
                for x in inputs:
                    fn(x)
                torch.cuda.synchronize()
            out["by_kernel"][name] = _by_kernel(prof, len(inputs))
        return ms

    def k3_point(name, fn, inputs):
        fn(inputs[0])
        torch.cuda.synchronize()
        row = {"device_ms": device_ms(fn, inputs, dev),
               "call_ms": cuda_ms(fn, inputs, dev)}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(10):
            for x in inputs:
                fn(x)
        row["host_us"] = (time.perf_counter() - t0) / (10 * len(inputs)) * 1e6
        torch.cuda.synchronize()
        row["device_ms_again"] = device_ms(fn, inputs, dev)
        if profile:
            with torch_profile(activities=[ProfilerActivity.CUDA]) as prof:
                for x in inputs:
                    fn(x)
                torch.cuda.synchronize()
            out["by_kernel"][name] = _by_kernel(prof, len(inputs))
        return row

    db = torch.randint(0, 256, (N, D), generator=g, device=dev).float()
    norms = (db * db).sum(1)
    for nq, k in K1_POINTS if "k1" in kernels else ():
        qs = [torch.randint(0, 256, (nq, D), generator=g, device=dev).float()
              for _ in range(ITERS)]
        ms = timed(f"k1 {nq} {k}", lambda q, k=k: fused_topk(q, db, norms, N, k, l2), qs)
        out["k1"][f"{nq},{k}"] = ms
        print(f"  K1 batch={nq} k={k}: {ms:.4f} ms", flush=True)
        if (nq, k) == (256, 10):
            db_t = db.T
            torch.mm(qs[0], db_t)
            out["k1_mm_ms"] = cuda_ms(lambda q: torch.mm(q, db_t), qs, dev)
            print(f"  torch.mm [{nq},{D}] x [{D},{N}] f32: {out['k1_mm_ms']:.4f} ms",
                  flush=True)
    if "k1v" in kernels:  # the bf16x3 scan over the K1 corpus, beside K1 highest
        qs = [torch.randint(0, 256, (32, D), generator=g, device=dev).float()
              for _ in range(ITERS)]
        out["k1v"]["high,1Mx128,32"] = timed(
            "high 1Mx128 32", lambda q: fused_topk(q, db, norms, N, 10, l2,
                                                   precision="high"), qs)
        out["k1v"]["highest,1Mx128,32"] = timed(
            "highest 1Mx128 32", lambda q: fused_topk(q, db, norms, N, 10, l2), qs)
        print(f"  K1 bf16x3 1M x {D} batch=32 k=10: {out['k1v']['high,1Mx128,32']:.4f} "
              f"ms; K1 highest {out['k1v']['highest,1Mx128,32']:.4f} ms", flush=True)
    for nq in K3_BATCHES if "k3" in kernels else ():
        cands = []
        for _ in range(2 * ITERS):
            c = torch.randint(0, N, (nq, K3_R), generator=g, device=dev,
                              dtype=torch.int32)
            c[::5, -7:] = -1  # a few queries with fewer valid rows than R
            qd = torch.randint(0, 256, (nq, D), generator=g, device=dev).float()
            cands.append((qd, c))
        flat = [c.reshape(-1).clamp(min=0) for _, c in cands]  # rows to fetch
        for key, fn, inputs in (
                (f"rescore,{nq}", lambda p: rescore_candidates(
                    p[0], db, norms, p[1], K3_K, l2), cands),
                (f"gather,{nq * K3_R}", lambda i: gather_rows(db, i), flat),
                (f"gather_int64,{nq * K3_R}", lambda i: gather_rows(db, i),
                 [i.long() for i in flat])):
            row = k3_point(key, fn, inputs)
            if key.startswith("gather"):
                sel = lambda i: torch.index_select(db, 0, i)  # noqa: E731
                sel(inputs[0])
                row["index_select_ms"] = device_ms(sel, inputs, dev)
            out["k3"][key] = row
            print(f"  K3 {key}: " + ", ".join(f"{a} {b:.4f}" for a, b in row.items()),
                  flush=True)
    del db, norms
    torch.cuda.empty_cache()

    for name, m, ksub, packed in K2_POINTS if "k2" in kernels else ():
        books = torch.randn((m, ksub, D // m), generator=g, device=dev)
        codes = torch.randint(0, ksub, (N, m), generator=g, device=dev,
                              dtype=torch.uint8)
        recon = torch.cat([books[j][codes[:, j].long()] for j in range(m)], 1)
        rnorms = (recon.double() ** 2).sum(1).float()
        del recon
        stored = (codes[:, 0::2] | (codes[:, 1::2] << 4)).contiguous() if packed else codes
        for nq in K2_BATCHES:
            qs = [torch.randn((nq, D), generator=g, device=dev) for _ in range(ITERS)]
            ms = timed(f"k2 {name} {nq}", lambda q: fused_adc_topk(
                q, stored, books, rnorms, N, K2_K, l2, None, True, packed), qs)
            out["k2"][f"{name},{nq}"] = ms
            print(f"  K2 {name} batch={nq} k={K2_K}: {ms:.4f} ms", flush=True)
        del books, codes, stored, rnorms
        torch.cuda.empty_cache()

    if "k2i8" in kernels:
        k2i8_points(out, timed, torch, fused_adc_topk, dev)
    if "k1v" in kernels:
        k1v_points(out, timed, torch, fused_topk, dev, g)
    if "k1bf16" in kernels:
        k1bf16_points(out, timed, torch, fused_topk, dev)
    if "k4" not in kernels:
        return out
    n_pad = -(-N // 8192) * 8192
    cols = torch.zeros((n_pad, SP_NNZ), dtype=torch.int32, device=dev)
    vals = torch.zeros((n_pad, SP_NNZ), device=dev)
    cols[:N] = torch.randint(0, SP_DIM, (N, SP_NNZ), generator=g, device=dev,
                             dtype=torch.int32)
    vals[:N] = torch.randn((N, SP_NNZ), generator=g, device=dev).abs()
    snorms = (vals * vals).sum(1)
    for nq in (256, 32):
        qts = []
        for _ in range(6):
            q = torch.zeros((nq, SP_DIM), device=dev)
            q.scatter_(1, torch.randint(0, SP_DIM, (nq, SP_QNNZ), generator=g, device=dev),
                       torch.randn((nq, SP_QNNZ), generator=g, device=dev).abs())
            qts.append(q.T.contiguous())
        ms = timed(f"k4 {nq}", lambda qt: ell_topk(
            qt, cols, vals, None, None, None, snorms, N, 10, ip), qts)
        out["k4"][str(nq)] = ms
        print(f"  K4 ell_topk batch={nq} k=10: {ms:.4f} ms", flush=True)
    return out


def k2i8_points(out, timed, torch, fused_adc_topk, dev) -> None:
    """K2's int8 LUT and the bf16 LUT beside it at the K2 points, on inputs
    of a generator of their own (the same in every checkout)."""
    from metrovector_tpu_torch import DistanceMetric

    l2 = DistanceMetric.L2
    g = torch.Generator(device=dev)
    g.manual_seed(12)
    for name, m, ksub, packed in K2_POINTS:
        books = torch.randn((m, ksub, D // m), generator=g, device=dev)
        codes = torch.randint(0, ksub, (N, m), generator=g, device=dev, dtype=torch.uint8)
        rnorms = torch.rand(N, generator=g, device=dev) * 100
        stored = (codes[:, 0::2] | (codes[:, 1::2] << 4)).contiguous() if packed else codes
        for nq in K2_BATCHES:
            qs = [torch.randn((nq, D), generator=g, device=dev) for _ in range(ITERS)]
            for lut, kw in (("int8", {"int8_lut": True}), ("bf16", {})):
                ms = timed(f"k2i8 {name} {nq} {lut}", lambda q, kw=kw: fused_adc_topk(
                    q, stored, books, rnorms, N, K2_K, l2, None, False, packed, **kw), qs)
                out["k2i8"][f"{name},{nq},{lut}"] = ms
                print(f"  K2 {lut} LUT {name} batch={nq} k={K2_K}: {ms:.4f} ms", flush=True)
        del books, codes, stored, rnorms
        torch.cuda.empty_cache()


def k1v_points(out, timed, torch, fused_topk, dev, g) -> None:
    """The integer and bf16x3 points of K1's variants (module docstring)."""
    from metrovector_tpu_torch import DistanceMetric
    from metrovector_tpu_torch.utils.timing import cuda_ms

    l2, ip, cos = (DistanceMetric.L2, DistanceMetric.INNER_PRODUCT,
                   DistanceMetric.COSINE)
    n, d = K1V_INT_N, K1V_INT_D
    rows = torch.randint(-128, 128, (n, K1V_INT_WIDTH), generator=g, device=dev,
                         dtype=torch.int8)
    x, zn = rows[:, :d], torch.zeros(n, device=dev)
    for nq in (128, 32):
        qs = [torch.randint(-128, 128, (nq, d), generator=g, device=dev,
                            dtype=torch.int8) for _ in range(ITERS)]
        ms = timed(f"int8 deep10m {nq}", lambda q: fused_topk(
            q, x, zn, n, 10, ip, scale=0.02), qs)
        out["k1v"][f"int8,deep10m,{nq}"] = ms
        line = f"  K1 int8 {n} x {d} (rows of {K1V_INT_WIDTH}) batch={nq} k=10: {ms:.4f} ms"
        if nq == 128:
            qt = [torch.nn.functional.pad(q, (0, K1V_INT_WIDTH - d)).T.contiguous()
                  for q in qs]
            torch._int_mm(rows, qt[0])
            mm = cuda_ms(lambda b: torch._int_mm(rows, b), qt[:3], dev)
            out["k1v"]["int_mm,deep10m,128"] = mm
            line += f"; torch._int_mm on the padded rows {mm:.4f} ms"
        print(line, flush=True)
    del rows, x, zn
    m = 1_000_000
    u = torch.randint(-128, 128, (m, D), generator=g, device=dev, dtype=torch.int8)
    un = ((u.double() + 128) ** 2).sum(1).float()
    bias = u.sum(1, dtype=torch.int32).float()
    qs = [torch.randint(-128, 128, (256, D), generator=g, device=dev, dtype=torch.int8)
          for _ in range(ITERS)]
    out["k1v"]["int8,sift1m-u8,256"] = timed("int8 sift1m-u8 256", lambda q: fused_topk(
        q, u, un, m, 10, l2, scale=128 / 127, bias_row=bias, bias_scale=128.0), qs)
    print(f"  K1 int8 uint8-offset {m} x {D} batch=256 k=10: "
          f"{out['k1v']['int8,sift1m-u8,256']:.4f} ms", flush=True)
    del u, un, bias
    torch.cuda.empty_cache()
    xg = torch.randn((m, K1V_GIST_D), generator=g, device=dev)
    gn = (xg.double() ** 2).sum(1).float()
    for nq in (256, 64):
        qs = []
        for _ in range(4):
            q = torch.randn((nq, K1V_GIST_D), generator=g, device=dev)
            qs.append(q / q.norm(dim=1, keepdim=True))
        ms = timed(f"high gist1m {nq}", lambda q: fused_topk(
            q, xg, gn, m, 18, cos, precision="high"), qs)
        out["k1v"][f"high,gist1m,{nq}"] = ms
        print(f"  K1 bf16x3 {m} x {K1V_GIST_D} cosine batch={nq} k=18: {ms:.4f} ms",
              flush=True)
    del xg, gn
    torch.cuda.empty_cache()


def k1bf16_points(out, timed, torch, fused_topk, dev) -> None:
    """K1 over bf16 rows (module docstring), on inputs of a generator of
    their own (the same in every checkout)."""
    from metrovector_tpu_torch import DistanceMetric
    from metrovector_tpu_torch.ops import topk_kernel

    l2, cos = DistanceMetric.L2, DistanceMetric.COSINE
    g = torch.Generator(device=dev)
    g.manual_seed(18)
    # The one-pass kernel where the checkout has it, else the FFMA kernel.
    route = "default" if "default" in topk_kernel._PRECISIONS else "ffma"
    out["k1bf16_route"] = route
    kw = {"precision": "default"} if route == "default" else {}
    xb = torch.randint(0, 256, (N, D), generator=g, device=dev).to(torch.bfloat16)
    nb = (xb.double() ** 2).sum(1).float()
    for nq in (256, 32):
        qs = [torch.randint(0, 256, (nq, D), generator=g, device=dev).float()
              for _ in range(ITERS)]
        ms = timed(f"bf16 1Mx128 {nq}", lambda q: fused_topk(q, xb, nb, N, 10, l2, **kw), qs)
        out["k1bf16"][f"1Mx128,{nq}"] = ms
        print(f"  K1 over bf16 rows ({route}) {N} x {D} batch={nq} k=10: {ms:.4f} ms",
              flush=True)
    del xb, nb
    torch.cuda.empty_cache()
    xg = torch.randn((N, K1V_GIST_D), generator=g, device=dev).to(torch.bfloat16)
    gn = (xg.double() ** 2).sum(1).float()
    qs = []
    for _ in range(4):
        q = torch.randn((256, K1V_GIST_D), generator=g, device=dev)
        qs.append((q / q.norm(dim=1, keepdim=True)).to(torch.bfloat16).float())
    ms = timed("bf16 gist1m 256", lambda q: fused_topk(q, xg, gn, N, 10, cos, **kw), qs)
    out["k1bf16"]["gist1m,256"] = ms
    print(f"  K1 over bf16 rows ({route}) {N} x {K1V_GIST_D} cosine batch=256 k=10: "
          f"{ms:.4f} ms", flush=True)
    del xg, gn
    torch.cuda.empty_cache()


def search_p50(files: str) -> dict:
    """search() p50 in ms, k=10, at batches 32 and 256, over the files that
    chip_smoke.py wrote to ``files``: the dense 1M x 128 space
    (``sift1m_like.mvt``, integer queries) and the PQ spaces
    (``sift1m-pq4.mvt``, ``sift1m-pq.mvt``, rerank 400, queries that are
    noisy copies of corpus rows, rounded), queries from fixed seeds. On the
    PQ spaces also the int8 LUT's search() p50 (``name,nq,int8``) and K2's
    own time on the index, by CUDA events, at the searches' k = 400, with
    the int8 and the bf16 LUT (``name,nq,K2 int8`` and ``K2 bf16``)."""
    import numpy as np
    import torch

    from metrovector_tpu_torch import DistanceMetric, Reader, SearchEngine
    from metrovector_tpu_torch.index.pq import PQIndex
    from metrovector_tpu_torch.ops.adc_kernel import fused_adc_topk
    from metrovector_tpu_torch.utils.timing import cuda_ms, sync_time

    dev = torch.device("cuda", 0)
    out = {}

    def p50(point, search, qs):
        search(qs[0])
        out[point] = float(np.median([sync_time(search, q, device=dev)[0]
                                      for q in qs])) * 1e3
        print(f"  {point} search() p50 {out[point]:.4f} ms", flush=True)

    for name in ("sift1m_like", "sift1m-pq4", "sift1m-pq"):
        path = os.path.join(files, name + ".mvt")
        if not os.path.exists(path):
            continue
        space = Reader.open(path).vector_space("sift")
        rng = np.random.default_rng(11)
        if name == "sift1m_like":
            index = SearchEngine(space, device="cuda")
            for nq in (32, 256):
                p50(f"{name},{nq}", index.search,
                    [rng.integers(0, 256, (nq, D)).astype(np.float32) for _ in range(20)])
            del index
            torch.cuda.empty_cache()
            continue
        index = PQIndex.from_space(space, device="cuda")
        x = index.db
        args = (index.codes, index._books, index.recon_norms, index.num_vectors, K2_K,
                DistanceMetric.L2, index.valid, False, index.packed4)
        for nq in (32, 256):
            qs = []
            for _ in range(20):
                rows = torch.from_numpy(rng.integers(0, x.shape[0], nq)).to(dev)
                base = x[rows].cpu().numpy()
                qs.append(np.clip(np.rint(base + rng.normal(0, 8, base.shape)), 0,
                                  255).astype(np.float32))
            p50(f"{name},{nq}", lambda q: index.search(q, k=10, rerank=K2_K), qs)
            p50(f"{name},{nq},int8", lambda q: index.search(q, k=10, rerank=K2_K,
                                                             int8_lut=True), qs)
            qd = [torch.from_numpy(q).to(dev) for q in qs[:ITERS]]
            for lut, kw in (("int8", {"int8_lut": True}), ("bf16", {})):
                run = lambda q, kw=kw: fused_adc_topk(q, *args, **kw)  # noqa: E731
                run(qd[0])
                out[f"{name},{nq},K2 {lut}"] = cuda_ms(run, qd, dev)
                print(f"  {name} batch={nq} K2 {lut} LUT k={K2_K}: "
                      f"{out[f'{name},{nq},K2 {lut}']:.4f} ms", flush=True)
        del index
        torch.cuda.empty_cache()
    return out


def turns(args) -> int:
    """The kernels of ``args.turns``' checkout and this one in turns (other,
    this, this, other), each in a process of its own; prints each run's
    JSON and, last, the medians by checkout."""
    import statistics

    other = os.path.abspath(args.turns)
    runs = {other: [], ROOT: []}
    for root in (other, ROOT, ROOT, other):
        cmd = [sys.executable, os.path.abspath(__file__), "--root", root,
               "--kernels", args.kernels] + [f"--define={d}" for d in args.define]
        run = subprocess.run(cmd, capture_output=True, text=True, timeout=1800)
        if run.returncode != 0:
            print(f"timing {root} failed:\n{run.stderr[-3000:]}", file=sys.stderr)
            return 1
        got = json.loads(run.stdout.strip().splitlines()[-1])
        runs[root].append(got)
        print(json.dumps(got), flush=True)
    medians = {}
    for root, got in runs.items():
        medians[root] = {
            part: {point: statistics.median(g[part][point] for g in got)
                   for point in got[0][part] if isinstance(got[0][part][point], float)}
            for part in ("k1", "k1v", "k1bf16", "k2", "k2i8", "k4") if got[0].get(part)}
    result = {"turns": [other, ROOT, ROOT, other], "medians": medians}
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"runs": runs, **result}, f, indent=1)
    print(json.dumps(result), flush=True)
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=ROOT)
    ap.add_argument("--define", action="append", default=[])
    ap.add_argument("--profile", action="store_true")
    ap.add_argument("--kernels", default="k1,k1v,k1bf16,k2,k3,k4",
                    help="which of k1, k1v, k1bf16, k2, k2i8, k3, k4 to time "
                    "(comma-separated)")
    ap.add_argument("--turns", help="another checkout: time it and this one in "
                    "turns (DIR, this, this, DIR), a process each")
    ap.add_argument("--files", help="a directory of chip_smoke.py's files: "
                    "also time search() p50 on them")
    ap.add_argument("--out")
    args = ap.parse_args()
    if args.turns:
        return turns(args)
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import torch

    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 1
    from metrovector_tpu_torch.ops import _build

    if not _build.CSRC.is_relative_to(root):
        print(f"metrovector_tpu_torch came from {_build.CSRC}, not {root}",
              file=sys.stderr)
        return 1
    _build.NVCC_FLAGS.extend(args.define)
    result = {"root": root, "defines": args.define,
              **measure(args.profile, set(args.kernels.split(",")))}
    result["e2e"] = search_p50(args.files) if args.files else {}
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
