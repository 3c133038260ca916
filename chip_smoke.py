#!/usr/bin/env python3
"""Drive the PyTorch + CUDA port's main path once on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one line each; any failure exits non-zero:

0. device: require CUDA, print the card's name and power limit, pin full
   f32 (no TF32) for matmul and cuDNN;
1. build: compile the fused top-k kernel from the sources in this checkout;
2. kernel vs plain: ``fused_topk`` against ``fused_topk_reference`` on the
   same CUDA tensors over metrics, corpus dtypes, masks, batch sizes and k;
3. main path at full size: ``Builder`` writes a 1M x 128 integer-valued
   f32 L2 space, ``Reader.open`` -> ``SearchEngine(device="cuda")`` ->
   ``search`` at k=10 (batches 32-256) and k=100, recall against a float64
   NumPy oracle, the kernel's launch count, and CUDA-event times of the
   kernel and of its plain version;
4. filters, tombstones and stable IDs;
5. serving: the shared ``MicroBatcher`` answers 64 concurrent requests.

The second-to-last line is a JSON object describing each kernel; the last
line is ``{"ok": true, "device": {...}}``. Imports nothing of JAX.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

N_MAIN, D_MAIN = 1_000_000, 128
SEED = 7
KERNEL_SOURCE = "metrovector_tpu_torch/ops/csrc/topk_kernel.cu"
KERNEL_REPLACES = "metrovector_tpu/ops/topk_kernel.py:741"


def say(*parts) -> None:
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


def phase_build() -> None:
    from metrovector_tpu_torch.ops import _build

    t0 = time.perf_counter()
    _build.load()
    dt = time.perf_counter() - t0
    log = (_build.build_dir() / "build.log").read_text()
    for line in log.splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            say("  ptxas:", line.strip())
    say(f"phase 1 build: ok ({dt:.2f} s, {_build.build_dir()})")


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
    n, d = 3001, 128  # a multiple of no tile (32 queries, 128 rows, 64 dims)
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
    empty = torch.empty((0, d), device=dev)  # an empty corpus launches nothing
    s_e, i_e = fused_topk(torch.ones((3, d), device=dev), empty,
                          torch.empty(0, device=dev), 0, 5, DistanceMetric.L2)
    if not (torch.isneginf(s_e).all() and (i_e == -1).all()):
        raise AssertionError("an empty corpus did not give (-inf, -1) slots")
    torch.cuda.synchronize()
    say(f"phase 2 kernel vs plain: ok ({cases} cases, max |score diff| "
        f"{max_err:.3g})")
    return max_err, cases


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


def phase_main_path(torch, dev, card):
    from metrovector_tpu_torch import Builder, DistanceMetric, Reader, SearchEngine
    from metrovector_tpu_torch.ops.topk_kernel import (
        fused_topk, fused_topk_reference,
    )
    from metrovector_tpu_torch.utils.timing import cuda_ms, sync_time

    rng = np.random.default_rng(SEED)
    x = rng.integers(0, 256, (N_MAIN, D_MAIN)).astype(np.float32)
    tmp = tempfile.TemporaryDirectory()
    path = os.path.join(tmp.name, "sift1m_like.mvt")
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


def main() -> int:
    import torch

    card_name, card = phase_device(torch)
    dev = torch.device("cuda", 0)
    phase_build()
    max_err, _ = phase_kernel_vs_plain(torch, dev)
    engine, tmp, launches, times = phase_main_path(torch, dev, card)
    try:
        phase_filters_ids(torch, engine)
        phase_serving(engine)
    finally:
        tmp.cleanup()
    kms, pms = times[(256, 10)]
    say(json.dumps({"kernels": [{
        "name": "fused_topk", "route": "cuda", "source": KERNEL_SOURCE,
        "replaces": KERNEL_REPLACES, "launches": launches,
        "max_abs_err": max_err, "ms": kms, "plain_ms": pms,
    }]}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": card_name,
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
