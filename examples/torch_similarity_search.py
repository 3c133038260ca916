"""Clustered similarity search with metadata-aware analysis, on the
PyTorch + CUDA port.

The counterpart of ``examples/similarity_search.py``: 3 clusters of 20
vectors, exact cosine top-5 per cluster, then the IVF index at nprobe=1,
with the same seed and printed lines, on the card (``--device cpu`` runs
the kernels' plain versions on the host).

Run:  python examples/torch_similarity_search.py [--device cuda|cpu]
"""

import argparse
import os
import sys
import tempfile

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import metrovector_tpu_torch as mvt
from metrovector_tpu_torch.index import IVFIndex


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    rng = np.random.default_rng(7)
    centers = {
        "animals": rng.standard_normal(48).astype(np.float32) * 3,
        "cities": rng.standard_normal(48).astype(np.float32) * 3,
        "foods": rng.standard_normal(48).astype(np.float32) * 3,
    }
    rows, labels = [], []
    for name, c in centers.items():
        rows.append(c + 0.3 * rng.standard_normal((20, 48)).astype(np.float32))
        labels += [name] * 20
    data = np.concatenate(rows)

    out = {"exact": []}
    with tempfile.TemporaryDirectory() as tmp:
        b = mvt.Builder()
        b.add_vector_space("items", dim=48, metric=mvt.DistanceMetric.COSINE)
        b.add_vectors("items", data)
        b.add_metadata_column("items", "cluster", labels)
        path = os.path.join(tmp, "clusters.mvt")
        b.build().save(path)

        space = mvt.Reader.open(path).vector_space("items")
        engine = mvt.SearchEngine(space, device=args.device)
        clusters = space.metadata_column("cluster")

        for name, c in centers.items():
            query = c + 0.3 * rng.standard_normal(48).astype(np.float32)
            res = engine.search(query, k=5)
            hits = [clusters[i] for i, _ in res.top(0)]
            purity = hits.count(name) / len(hits)
            print(f"query near {name!r}: top-5 clusters {hits} (purity {purity:.0%})")
            out["exact"].append(res.indices[0])

        # IVF over the same space: 3 buckets, probe 1
        idx = IVFIndex.from_space(space, num_clusters=3, iters=10, device=args.device)
        q = centers["cities"] + 0.3 * rng.standard_normal(48).astype(np.float32)
        res = idx.search(q, k=5, nprobe=1)
        hits = [clusters[i] for i in res.indices[0] if i >= 0]
        print(f"IVF nprobe=1: {hits}")
        out["ivf"] = res.indices[0]
    return out


if __name__ == "__main__":
    main()
