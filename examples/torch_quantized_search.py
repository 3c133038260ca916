"""Compressed search on the PyTorch + CUDA port: PQ and IVF-PQ with exact
re-ranking.

The counterpart of ``examples/quantized_search.py``, with the same data,
seed and printed lines:

1. train PQ codebooks on the corpus (k-means per subspace on the device),
2. persist codes + codebooks in the MVT file alongside the dense rows,
3. reopen and search three ways (exact through K1; PQ-ADC through K2 and
   the exact re-rank through K3; IVF-PQ in both serving modes) and
   compare recall and working-set size.

Run:  python examples/torch_quantized_search.py [--device cuda|cpu]
"""

import argparse
import os
import sys
import tempfile

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import metrovector_tpu_torch as mvt
from metrovector_tpu_torch.index import IVFPQIndex, PQIndex, encode_pq, train_pq
from metrovector_tpu_torch.ops import numpy_oracle


def recall(indices, oracle, k):
    return np.mean(
        [len(set(indices[i]) & set(oracle[i])) / k for i in range(len(indices))]
    )


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = args.device
    rng = np.random.default_rng(11)
    n, d, k = 20_000, 16, 10
    centers = rng.standard_normal((64, d)).astype(np.float32)
    # Noise ~ the center spacing (moderate dim, so clusters genuinely
    # overlap): each query's true top-10 spans several coarse cells and
    # the nprobe sweep below has something to trade off.
    data = (
        centers[rng.integers(0, 64, n)]
        + 2.0 * rng.standard_normal((n, d)).astype(np.float32)
    )
    queries = (
        centers[rng.integers(0, 64, 16)]
        + 2.0 * rng.standard_normal((16, d)).astype(np.float32)
    )

    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        # Train + persist: dense rows AND the PQ sidecar live in one file.
        books = train_pq(data, m=4, ksub=256, iters=6, device=device)
        codes = encode_pq(data, books, device=device)
        b = mvt.Builder()
        b.add_vector_space("emb", dim=d, metric=mvt.DistanceMetric.L2)
        b.add_vectors("emb", data)
        b.set_pq_index("emb", books, codes)
        path = os.path.join(tmp, "quantized.mvt")
        b.build().save(path)
        print(f"file: {os.path.getsize(path) / 1e6:.1f} MB "
              f"(dense {data.nbytes / 1e6:.1f} MB + codes {codes.nbytes / 1e6:.1f} MB)")

        _, oracle = numpy_oracle(queries, data, k, mvt.DistanceMetric.L2)

        # 1. Exact engine: the recall-1.0 baseline.
        eng = mvt.SearchEngine.open(path, device=device)
        res = eng.search(queries, k=k)
        out["exact"] = recall(res.indices, oracle, k)
        out["exact_indices"] = res.indices
        print(f"exact          recall@{k}: {out['exact']:.3f}  "
              f"working set {data.nbytes / 1e6:6.1f} MB")

        # 2. PQ: codes only on device (32x smaller), ADC + exact re-rank.
        sp = mvt.Reader.open(path).vector_space("emb")
        pq = PQIndex.from_space(sp, device=device)  # the persisted codebooks/codes
        res = pq.search(queries, k=k, rerank=8 * k)
        out["pq"] = recall(res.indices, oracle, k)
        print(f"pq m=4 rr=80   recall@{k}: {out['pq']:.3f}  "
              f"working set {pq.codes.nbytes / 1e6 + pq.recon_norms.nbytes / 1e6:6.1f} MB "
              "(codes)")

        # 3. IVF-PQ: probe a few coarse cells, residual ADC inside them.
        #    mode="auto" picks the formulation by batch size: the probe for
        #    latency batches, the scan (K2's bucket kernel over the probed
        #    buckets) for batch serving (same nprobe semantics).
        ivfpq = IVFPQIndex.from_space(sp, num_clusters=64, m=4, ksub=64, iters=6,
                                      device=device)
        for nprobe in (2, 8, 32):
            res = ivfpq.search(queries, k=k, nprobe=nprobe, rerank=8 * k)
            res_scan = ivfpq.search(
                queries, k=k, nprobe=nprobe, rerank=8 * k,
                mode="scan", exact_lut=True,
            )
            agree = (res.indices == res_scan.indices).mean()
            out[f"ivfpq{nprobe}"] = recall(res.indices, oracle, k)
            out[f"agree{nprobe}"] = agree
            print(f"ivfpq nprobe={nprobe:<3} recall@{k}: "
                  f"{out[f'ivfpq{nprobe}']:.3f}  "
                  f"(scan mode agrees: {agree:.0%})")
    return out


if __name__ == "__main__":
    main()
