"""The port stands alone: ``import metrovector_tpu_torch`` and a dense, a
PQ, an IVF-PQ (both modes), a sparse, a ``Database``, an HNSW and a
streamed search on its CPU path, and its CLI's ``info``, load no module of
the JAX package
(``metrovector_tpu`` or ``metrovector_tpu.*``), no JAX, no ``ml_dtypes`` and
no Triton. Checked in a fresh interpreter, because the pytest process
imported JAX at start; once as installed and once with ``ml_dtypes`` made
unimportable, as on a machine that does not have it. A scan of the sources
holds every module of the port and ``chip_smoke.py`` to the same rule.
Importing the multi-device layer (``metrovector_tpu_torch.parallel``)
starts no process group and touches no card. The port exports every
top-level name of the JAX package; :data:`UNPORTED` lists none."""

import json
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent
PORT = REPO / "metrovector_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "ml_dtypes", "triton")
# Top-level names of the JAX package that the port does not have: none
# since the multi-device layer was ported.
UNPORTED: set[str] = set()

_SCRIPT = r"""
import json, os, sys, tempfile
if {block_ml_dtypes}:
    sys.modules["ml_dtypes"] = None  # import ml_dtypes now raises
import numpy as np
import torch
import metrovector_tpu_torch as mvt
import metrovector_tpu_torch.parallel
from metrovector_tpu_torch.parallel import distributed, mesh, sharded_search, sparse_sharded
untouched = [torch.distributed.is_initialized(), torch.cuda.is_initialized()]
from metrovector_tpu_torch.utils import timing, transfer
from metrovector_tpu_torch.index import pq
from metrovector_tpu_torch.ops import adc_kernel, gather_kernel, sparse_kernel
b = mvt.Builder()
b.add_vector_space("v", dim=8)
b.add_vectors("v", np.arange(64, dtype=np.float32).reshape(8, 8))
b.add_vector_space("s", dim=8, vector_type=mvt.VectorType.SPARSE,
                   metric=mvt.DistanceMetric.INNER_PRODUCT)
b.add_sparse_vectors("s", [([i], [1.0 + i]) for i in range(8)])
path = os.path.join(tempfile.mkdtemp(), "i.mvt")
b.build().save(path)
res = mvt.SearchEngine.open(path, "v", device="cpu").search(np.ones((1, 8), np.float32), k=3)
reader = mvt.Reader.open(path)
idx = mvt.PQIndex.from_space(reader.vector_space("v"), m=2, ksub=4, iters=2,
                             device="cpu")
pq_top = idx.search(np.ones((1, 8), np.float32), k=3, rerank=4).indices
sp_top = mvt.SparseSearchEngine(reader.vector_space("s"), device="cpu").search(
    np.ones((1, 8), np.float32), k=3).indices
ivfpq = mvt.IVFPQIndex.from_space(reader.vector_space("v"), num_clusters=2, m=2,
                                  ksub=4, iters=2, device="cpu")
ivfpq_top = [ivfpq.search(np.ones((1, 8), np.float32), k=3, nprobe=2, rerank=8,
                          mode=mode).indices.tolist() for mode in ("scan", "probe")]
db_top = mvt.Database.open(path, device="cpu").search(
    "v", np.ones((1, 8), np.float32), k=3).indices
hnsw = mvt.HNSWIndex.from_space(reader.vector_space("v"), m=4, ef_construction=16)
hnsw_top = hnsw.search(np.ones((1, 8), np.float32), k=3).indices
stream_top = mvt.StreamingSearcher(reader.vector_space("v"), chunk_rows=8,
                                   device="cpu").search(np.ones((1, 8), np.float32), k=3).indices
import contextlib, io
from metrovector_tpu_torch.__main__ import main as cli
info = io.StringIO()
with contextlib.redirect_stdout(info):
    rc = cli(["info", path])
print(json.dumps({{
    "loaded": sorted(m for m in sys.modules if sys.modules[m] is not None),
    "top": res.indices.tolist(),
    "pq_top": pq_top.tolist(),
    "sp_top": sp_top.tolist(),
    "ivfpq_top": ivfpq_top,
    "db_top": db_top.tolist(),
    "hnsw_top": hnsw_top.tolist(),
    "stream_top": stream_top.tolist(),
    "info": [rc, info.getvalue()],
    "untouched": untouched,
}}))
"""


def _run(block_ml_dtypes: bool) -> dict:
    env = {**os.environ, "PYTHONPATH": str(REPO)}
    out = subprocess.run(
        [sys.executable, "-c", _SCRIPT.format(block_ml_dtypes=block_ml_dtypes)],
        capture_output=True, text=True, cwd=REPO, env=env, timeout=120,
    )
    assert out.returncode == 0, out.stderr
    return json.loads(out.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("block_ml_dtypes", [False, True],
                         ids=["as_installed", "without_ml_dtypes"])
def test_port_imports_no_jax(block_ml_dtypes):
    got = _run(block_ml_dtypes)
    assert got["top"] == [[0, 1, 2]]
    assert got["pq_top"] == [[0, 1, 2]]
    assert got["sp_top"] == [[7, 6, 5]]
    assert got["ivfpq_top"] == [[[0, 1, 2]], [[0, 1, 2]]]
    assert got["db_top"] == [[0, 1, 2]]
    assert got["hnsw_top"] == [[0, 1, 2]]
    assert got["stream_top"] == [[0, 1, 2]]
    assert got["info"][0] == 0 and "2 space(s)" in got["info"][1]
    assert got["untouched"] == [False, False]  # no process group, no CUDA context
    loaded = set(got["loaded"])
    jax_package = {m for m in loaded
                   if m == "metrovector_tpu" or m.startswith("metrovector_tpu.")}
    assert jax_package == set()
    assert not {m.split(".")[0] for m in loaded} & set(FORBIDDEN)


def test_port_sources_import_no_jax():
    """No module of the port, not chip_smoke.py and not the port's examples
    (``examples/torch_*.py`` and their ``_answer_lines.py``) names jax,
    ml_dtypes, triton or the JAX package in an import."""
    pattern = re.compile(
        r"^\s*(import|from)\s+(%s|metrovector_tpu(?!_torch))\b" % "|".join(FORBIDDEN),
        re.M,
    )
    examples = sorted((REPO / "examples").glob("torch_*.py"))
    assert len(examples) == 10
    sources = (list(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"] + examples
               + [REPO / "examples" / "_answer_lines.py"])
    scanned = {str(p.relative_to(REPO)) for p in sources}
    assert {"metrovector_tpu_torch/index/pq.py", "metrovector_tpu_torch/sparse.py",
            "metrovector_tpu_torch/index/ivf.py", "metrovector_tpu_torch/index/ivfpq.py",
            "metrovector_tpu_torch/ops/sparse_kernel.py",
            "metrovector_tpu_torch/format/constants.py", "chip_smoke.py",
            "metrovector_tpu_torch/database.py",
            "metrovector_tpu_torch/index/hnsw.py", "metrovector_tpu_torch/__main__.py",
            "metrovector_tpu_torch/parallel/streaming.py",
            "metrovector_tpu_torch/parallel/mesh.py",
            "metrovector_tpu_torch/parallel/sharded_search.py",
            "metrovector_tpu_torch/parallel/distributed.py",
            "metrovector_tpu_torch/parallel/sparse_sharded.py",
            "metrovector_tpu_torch/parallel/dryrun.py",
            "metrovector_tpu_torch/utils/timing.py",
            "examples/torch_multihost.py", "examples/torch_large_dataset.py"} <= scanned
    offenders = [str(p.relative_to(REPO)) for p in sources
                 if pattern.search(p.read_text())]
    assert offenders == []


def test_port_exports_the_reference_names():
    import metrovector_tpu as jax_mvt
    import metrovector_tpu_torch as port_mvt

    ported = set(jax_mvt.__all__) - UNPORTED
    assert UNPORTED <= set(jax_mvt.__all__)
    assert ported - set(port_mvt.__all__) == set()
    for name in sorted(ported):
        assert getattr(port_mvt, name) is not None, name
    assert port_mvt.train_kmeans.__module__ == "metrovector_tpu_torch.index.ivf"
