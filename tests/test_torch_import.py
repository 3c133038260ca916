"""``import metrovector_tpu_torch`` (its PQ index and kernel modules
included) and a dense and a PQ search on its CPU path pull in no
JAX, no Triton and none of the JAX package's device modules. Checked in a
fresh interpreter, because this test session imported JAX at start.

``ml_dtypes`` is the one shared-layer subtlety: the shared
``metrovector_tpu.format.constants`` imports it when it is installed (for
its bfloat16 numpy dtype). So one case checks that the port adds no such
import of its own, and another runs the port with ``ml_dtypes`` made
unimportable, as on a machine that does not have it."""

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
JAX_DEVICE_MODULES = (
    "metrovector_tpu.engine", "metrovector_tpu.ops", "metrovector_tpu.index",
    "metrovector_tpu.parallel", "metrovector_tpu.database",
    "metrovector_tpu.sparse",
)

_SCRIPT = r"""
import json, os, sys, tempfile
if {block_ml_dtypes}:
    sys.modules["ml_dtypes"] = None  # import ml_dtypes now raises
import metrovector_tpu.format  # the shared layer alone
shared = set(sys.modules)
import numpy as np
import metrovector_tpu_torch as mvt
from metrovector_tpu_torch.utils import timing, transfer
from metrovector_tpu_torch.index import pq
from metrovector_tpu_torch.ops import adc_kernel, gather_kernel
b = mvt.Builder()
b.add_vector_space("v", dim=8)
b.add_vectors("v", np.arange(64, dtype=np.float32).reshape(8, 8))
path = os.path.join(tempfile.mkdtemp(), "i.mvt")
b.build().save(path)
res = mvt.SearchEngine.open(path, device="cpu").search(np.ones((1, 8), np.float32), k=3)
idx = mvt.PQIndex.from_space(mvt.Reader.open(path).vector_space("v"), m=2,
                             ksub=4, iters=2, device="cpu")
pq_top = idx.search(np.ones((1, 8), np.float32), k=3, rerank=4).indices
print(json.dumps({{
    "loaded": sorted(m for m in sys.modules if sys.modules[m] is not None),
    "added": sorted(m for m in set(sys.modules) - shared
                    if sys.modules[m] is not None),
    "top": res.indices.tolist(),
    "pq_top": pq_top.tolist(),
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


def _top_level(names):
    return {n.split(".")[0] for n in names}


@pytest.mark.parametrize("block_ml_dtypes", [False, True],
                         ids=["as_installed", "without_ml_dtypes"])
def test_port_imports_no_jax(block_ml_dtypes):
    got = _run(block_ml_dtypes)
    assert got["top"] == [[0, 1, 2]]
    assert got["pq_top"] == [[0, 1, 2]]
    loaded = set(got["loaded"])
    assert not _top_level(got["added"]) & set(FORBIDDEN)
    assert not loaded & {"jax", "jaxlib", "triton"}
    assert not loaded & set(JAX_DEVICE_MODULES)
    if block_ml_dtypes:
        assert "ml_dtypes" not in loaded


def test_port_sources_import_no_jax():
    """No module of the port names jax, ml_dtypes or triton in an import."""
    pattern = re.compile(
        r"^\s*(import|from)\s+(%s)\b" % "|".join(FORBIDDEN), re.M
    )
    scanned = {str(p.relative_to(PORT)) for p in PORT.rglob("*.py")}
    assert {"index/pq.py", "index/ivf.py", "ops/adc_kernel.py",
            "ops/gather_kernel.py"} <= scanned
    offenders = [
        str(p.relative_to(REPO)) for p in PORT.rglob("*.py")
        if pattern.search(p.read_text())
    ]
    assert offenders == []
