"""Build → save → reopen → search, end to end, on the PyTorch + CUDA port.

The counterpart of ``examples/simple.py``: the same corpus, seed and
printed lines, searched by ``metrovector_tpu_torch.SearchEngine`` on the
card (``--device cpu`` runs the kernels' plain versions on the host).

Run:  python examples/torch_simple.py [--device cuda|cpu]
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
    rng = np.random.default_rng(42)
    docs = rng.standard_normal((1000, 64)).astype(np.float32)

    with tempfile.TemporaryDirectory() as tmp:
        # -- build & save ---------------------------------------------------
        builder = mvt.Builder()
        builder.add_vector_space(
            "documents", dim=64, metric=mvt.DistanceMetric.L2,
            dtype=mvt.DataType.FLOAT32,
        )
        builder.add_vectors("documents", docs)
        builder.add_metadata_column(
            "documents", "title", [f"doc-{i:04d}" for i in range(1000)]
        )
        path = os.path.join(tmp, "documents.mvt")
        builder.build().save(path)
        print(f"wrote {path} ({os.path.getsize(path):,} bytes)")

        # -- reopen & inspect -----------------------------------------------
        reader = mvt.Reader.open(path)
        reader.validate_with_checksum()
        print(f"spaces: {reader.vector_space_names}, version {reader.version}")
        space = reader.vector_space("documents")
        print(f"{space.num_vectors} vectors, dim {space.dim}, {space.dtype.name}")

        v = space.get_vector(0)
        print(f"vector 0, first 4 dims: {v.as_f32()[:4]}")

        # -- nearest neighbors on the device --------------------------------
        engine = mvt.SearchEngine(space, device=args.device)
        query = docs[123] + 0.05 * rng.standard_normal(64).astype(np.float32)
        result = engine.search(query, k=5)
        titles = space.metadata_column("title")
        print("top-5 neighbors of a noisy copy of doc-0123:")
        for idx, dist in result.top(0):
            print(f"  {titles[idx]}  L2={dist:.4f}")
    return {"indices": result.indices, "scores": result.scores}


if __name__ == "__main__":
    main()
