"""Serving patterns on the PyTorch + CUDA port: pipelined batches, metadata
filtering, compressed corpora, and single-query HNSW.

The counterpart of ``examples/serving.py``, with the same data, seed,
assertions and printed lines:

1. **Throughput path**: ``SearchEngine.search_pipelined`` keeps one batch
   in flight, so the host's work on a batch overlaps the card's on the
   next.
2. **Filtered search**: a metadata predicate becomes a row mask applied
   exactly inside the kernel (no post-filtering recall loss).
3. **Memory-bound corpora**: ``PQIndex`` codes (``4·D/m``× smaller) with
   exact re-ranking (K2, then K3).
4. **Latency path**: host-side HNSW for single queries with no device
   round-trip.
5. **Request coalescing**: ``MicroBatcher`` turns concurrent single-query
   callers into shared batched launches on a fixed shape ladder.
6. **Multi-tenant predicates in one batcher**: each request carries its
   own prepared metadata predicate (``Database.prepare_where``) and
   coalescing survives by grouping requests per predicate.

The microbatchers' launch and drain-window counts depend on when the
client threads' requests arrive, as their latencies do.

Run:  python examples/torch_serving.py [--device cuda|cpu]
"""

import argparse
import os
import sys
import tempfile
import threading
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import metrovector_tpu_torch as mvt
from metrovector_tpu_torch.index import HNSWIndex, PQIndex


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = args.device
    rng = np.random.default_rng(3)
    n, d = 30_000, 64
    data = rng.standard_normal((n, d)).astype(np.float32)
    shard = rng.integers(0, 4, n)

    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        b = mvt.Builder()
        b.add_vector_space("emb", dim=d)
        b.add_vectors("emb", data)
        b.add_metadata_column("emb", "tenant", [f"t{t}" for t in shard])
        path = os.path.join(tmp, "serve.mvt")
        b.build().save(path)
        sp = mvt.Reader.open(path).vector_space("emb")
        eng = mvt.SearchEngine(sp, device=device)

        # 1. pipelined throughput: stream of query batches, one in flight
        batches = [rng.standard_normal((64, d)).astype(np.float32) for _ in range(8)]
        t0 = time.perf_counter()
        results = list(eng.search_pipelined(iter(batches), k=10))
        dt = time.perf_counter() - t0
        print(f"pipelined: {8 * 64 / dt:,.0f} QPS over {len(results)} batches")
        out["pipelined"] = [r.indices for r in results]

        # 2. tenant-scoped search: exact within the filter
        tenants = np.asarray(sp.metadata_column("tenant"))
        mask = tenants == "t2"
        res = eng.search(batches[0][:4], k=5, filter_mask=mask)
        if not all(tenants[i] == "t2" for row in res.indices for i in row if i >= 0):
            raise AssertionError("a filtered hit is not tenant t2's")
        print(f"filtered: top-5 drawn only from tenant t2 ({mask.sum()} rows)")
        out["filtered"] = res.indices

        # 3. compressed working set: PQ codes + exact re-rank
        pq = PQIndex.build(data, mvt.DistanceMetric.L2, m=8, ksub=256, iters=5,
                           device=device)
        res_pq = pq.search(batches[0], k=10, rerank=100)
        ref = eng.search(batches[0], k=10)
        overlap = np.mean(
            [
                len(set(res_pq.indices[i]) & set(ref.indices[i])) / 10
                for i in range(64)
            ]
        )
        print(f"pq m=8 (+rerank 100): {8 / (d * 4):.1%} of f32 bytes, "
              f"recall vs exact {overlap:.2f}")
        out["pq_recall"] = overlap

        # 4. latency path: single query through HNSW, host-only
        hnsw = HNSWIndex.build(
            data[:10_000], mvt.DistanceMetric.L2, m=12, ef_construction=80
        )
        q1 = batches[0][:1]
        hnsw.search(q1, k=10, ef=64)  # warm
        t0 = time.perf_counter()
        for _ in range(20):
            hnsw.search(q1, k=10, ef=64)
        print(f"hnsw single-query p50: {(time.perf_counter() - t0) / 20 * 1e3:.2f} ms "
              "(no device round-trip)")

        # 5. request coalescing: concurrent single-query callers share
        #    batched kernel launches (MicroBatcher pads onto a fixed bucket
        #    ladder so the device sees O(log max_batch) query shapes)
        with mvt.MicroBatcher(eng, k=10, max_batch=64, max_wait_ms=3.0) as mb:
            qs = rng.standard_normal((80, d)).astype(np.float32)
            futs = [None] * len(qs)

            def client(lo, hi):
                for i in range(lo, hi):
                    futs[i] = mb.submit(qs[i])

            threads = [
                threading.Thread(target=client, args=(j * 20, (j + 1) * 20))
                for j in range(4)
            ]
            for t in threads:
                t.start()
            for t in threads:
                t.join()
            out["batched"] = np.stack([f.result(120).indices[0] for f in futs])
        s = mb.stats()
        print(f"microbatcher: {s.requests} requests in {s.batches} launches "
              f"(occupancy {s.occupancy:.0%}, p50 {s.p50_ms:.1f} ms)")

        # 6. multi-tenant serving: each request carries its own prepared
        #    predicate; same-tenant requests coalesce into the same batch,
        #    distinct tenants launch separately from the same drain window
        #    (stats().windows vs .batches shows the live diversity)
        db = mvt.Database.open(path, device=device)
        prepared = {
            t: db.prepare_where("emb", where=("tenant", "==", t), mode="exact")
            for t in ("t0", "t1", "t2")
        }
        with db.batcher("emb", k=5, max_wait_ms=5.0, mode="exact") as mb:
            futs2 = [
                mb.submit(qs[i], filter_mask=prepared[f"t{i % 3}"])
                for i in range(24)
            ]
            tenant_hits = []
            for i, f in enumerate(futs2):
                got = f.result(120)
                if not all(tenants[j] == f"t{i % 3}" for j in got.indices[0] if j >= 0):
                    raise AssertionError(f"request {i}: a hit outside tenant t{i % 3}")
                tenant_hits.append(got.indices[0])
            out["tenants"] = np.stack(tenant_hits)
        s2 = mb.stats()
        print(f"per-request predicates: {s2.requests} requests, 3 tenants -> "
              f"{s2.batches} launches over {s2.windows} drain windows")
    return out


if __name__ == "__main__":
    main()
