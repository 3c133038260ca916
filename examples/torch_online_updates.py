"""Online corpus lifecycle on the PyTorch + CUDA port: serve, mutate live,
persist, compact.

The counterpart of ``examples/online_updates.py``, with the same data,
seed, assertions and printed lines:

1. build + serve a corpus with stable IDs on the card,
2. add and delete rows on the LIVE device corpus (``DeviceSpace.add_rows``
   and ``delete_rows`` publish one new snapshot each),
3. persist the same changes through the file-side append workflow
   (``builder_from_reader``), verifying live and persisted states agree,
4. physically drop the deletions with ``compact``: IDs survive, row
   positions don't (which is why results carry IDs).

Run:  python examples/torch_online_updates.py [--device cuda|cpu]
"""

import argparse
import os
import sys
import tempfile

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import metrovector_tpu_torch as mvt
from metrovector_tpu_torch.engine import DeviceSpace, SearchEngine


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    rng = np.random.default_rng(0)
    dim = 64
    data = rng.standard_normal((5_000, dim)).astype(np.float32)
    ids = np.arange(5_000, dtype=np.uint64) + 1_000_000

    with tempfile.TemporaryDirectory() as tmp:
        # 1. build + serve
        b = mvt.Builder()
        b.add_vector_space("docs", dim=dim)
        b.add_vectors("docs", data, ids=ids)
        path = os.path.join(tmp, "docs.mvt")
        b.build().save(path)
        dev = DeviceSpace.from_space(mvt.Reader.open(path).vector_space("docs"),
                                     device=args.device)
        eng = SearchEngine(dev)

        # 2. live mutation: 200 new docs, 3 deletions by stable ID
        fresh = rng.standard_normal((200, dim)).astype(np.float32)
        fresh_ids = np.arange(200, dtype=np.uint64) + 9_000_000
        dev.add_rows(fresh, ids=fresh_ids)
        dev.delete_rows(ids=[1_000_007, 9_000_003, 1_004_999])
        res = eng.search(fresh[:3], k=2)
        print("live top hits (ids):", res.ids[:, 0], "(expect 9000000-range)")
        if not (res.ids[:, 0] == fresh_ids[:3]).all():
            raise AssertionError("the appended rows are not their own nearest neighbours")

        # 3. persist the same changes
        b2 = mvt.builder_from_reader(mvt.Reader.open(path))
        b2.add_vectors("docs", fresh, ids=fresh_ids)
        # file-side deletion is positional; resolve via the ID column (one
        # open + one lazy id->row map, hoisted out of the loop)
        v1_space = mvt.Reader.open(path).vector_space("docs")
        for vid in (1_000_007, 9_000_003, 1_004_999):
            row = (
                v1_space.row_for_id(vid) if vid < 9_000_000
                else 5_000 + int(vid - 9_000_000)
            )
            b2.delete_vector("docs", row)
        path2 = path + ".v2"
        b2.build().save(path2)
        eng2 = SearchEngine.open(path2, device=args.device)
        res2 = eng2.search(fresh[:3], k=2)
        if not np.array_equal(res2.ids, res.ids):
            raise AssertionError("persisted != live")
        print("persisted state matches the live-mutated engine")

        # 4. compact: deletions physically removed, IDs survive renumbering
        path3 = path + ".compact"
        mvt.compact(mvt.Reader.open(path2), path3)
        sp3 = mvt.Reader.open(path3).vector_space("docs")
        print(f"compacted: {sp3.num_vectors} rows (was 5200 with 3 tombstones)")
        if sp3.num_vectors != 5_197:
            raise AssertionError(f"compacted to {sp3.num_vectors} rows, not 5197")
        # a pre-compaction reference by ID still resolves
        row = sp3.row_for_id(1_000_042)
        if not np.allclose(sp3.get_vector(row).as_f32(), data[42], atol=1e-6):
            raise AssertionError("ID 1000042 resolves to another row after compaction")
        print("ID 1000042 still resolves after compaction (row moved to", row, ")")
    return {"live_ids": res.ids, "live_scores": res.scores, "persisted_ids": res2.ids,
            "compacted_row": row}


if __name__ == "__main__":
    main()
