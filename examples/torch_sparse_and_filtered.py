"""Sparse (SPLADE-style) retrieval and metadata-filtered serving on the
PyTorch + CUDA port.

The counterpart of ``examples/sparse_and_filtered.py``, with the same
data, seed, assertions and printed lines:

1. a sparse CSR space built, persisted and searched exactly (the ELL
   layout through K4 on the card),
2. a dense space served under metadata predicates compiled to exact row
   masks, with the hot predicate prepared once
   (``SearchEngine.prepare_filter``) and reused across query batches,
3. both spaces living in ONE file behind the ``Database`` facade.

Run:  python examples/torch_sparse_and_filtered.py [--device cuda|cpu]
"""

import argparse
import os
import sys
import tempfile

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import metrovector_tpu_torch as mvt


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    rng = np.random.default_rng(0)
    vocab, n_docs = 30_522, 20_000

    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        # --- build one file with a sparse space and a dense space ---------
        b = mvt.Builder()

        b.add_vector_space("docs-sparse", dim=vocab,
                           vector_type=mvt.VectorType.SPARSE,
                           metric=mvt.DistanceMetric.INNER_PRODUCT)
        rows = []
        for _ in range(n_docs):
            nnz = int(rng.integers(20, 80))  # SPLADE-ish term expansions
            cols = rng.choice(vocab, size=nnz, replace=False)
            rows.append((cols, np.abs(rng.standard_normal(nnz))
                         .astype(np.float32)))
        b.add_sparse_vectors("docs-sparse", rows)

        b.add_vector_space("docs-dense", dim=128)
        b.add_vectors("docs-dense",
                      rng.standard_normal((n_docs, 128)).astype(np.float32))
        b.add_metadata_column("docs-dense", "lang",
                              [("en" if i % 3 else "de")
                               for i in range(n_docs)])
        b.add_metadata_column("docs-dense", "year",
                              np.asarray(2015 + (np.arange(n_docs) % 10),
                                         np.int32))

        path = os.path.join(tmp, "mixed.mvt")
        b.build().save(path)
        print(f"built {os.path.getsize(path) / 1e6:.1f} MB:", path)

        db = mvt.Database.open(path, device=args.device)

        # --- 1. sparse retrieval ------------------------------------------
        # dense query vector over the sparse vocabulary (the SPLADE serving
        # shape); the facade routes to the sparse engine automatically
        q = np.zeros((2, vocab), np.float32)
        qcols = rng.integers(0, vocab, (2, 48))
        q[np.arange(2)[:, None], qcols] = 1.0
        res = db.search("docs-sparse", q, k=5)
        print("sparse top-5 doc ids:", res.indices[0].tolist())
        out["sparse"] = res.indices

        # predicates work on sparse spaces too (exact row masks)
        res = db.search("docs-sparse", q, k=5,
                        filter_mask=(np.arange(n_docs) % 2 == 0))
        if not all(i % 2 == 0 for i in res.indices[0] if i >= 0):
            raise AssertionError("the sparse filter let an odd row through")
        out["sparse_filtered"] = res.indices

        # --- 2. filtered dense serving with a prepared hot predicate ------
        eng = db.engine("docs-dense")
        recent_en = db.column_mask("docs-dense", "lang", "==", "en") & (
            db.column_mask("docs-dense", "year", ">=", 2020)
        )
        pf = eng.prepare_filter(recent_en)  # one upload, many batches
        out["filtered"] = []
        for _ in range(3):
            batch = rng.standard_normal((32, 128)).astype(np.float32)
            got = eng.search(batch, k=10, filter_mask=pf)
            if not recent_en[got.indices[got.indices >= 0]].all():
                raise AssertionError("a filtered hit fails lang=='en' & year>=2020")
            out["filtered"].append(got.indices)
        print("filtered serving: every hit satisfies lang=='en' & year>=2020")

        # one-shot predicates without preparation go through Database.search
        got = db.search("docs-dense", batch, k=10,
                        where=[("lang", "==", "de"), ("year", "<", 2018)])
        print("where=[lang==de, year<2018] hits:",
              int((got.indices >= 0).sum()))
        out["where"] = got.indices
    return out


if __name__ == "__main__":
    main()
