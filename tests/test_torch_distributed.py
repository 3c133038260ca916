"""The port's multi-process layer on the CPU: ``initialize`` doing nothing
in one process, ``global_mesh``, per-process shard loading
(``load_space_sharded``) and ``DistributedSearcher`` against the JAX
package's on the 8-device virtual CPU mesh, and a real process boundary:
two gloo ranks (``tests/_torch_mp_worker.py``, which imports no JAX) of
two CPU shards each over one file. The mirror of
``tests/test_distributed.py`` and ``tests/test_multiprocess.py``.

The data is integer-valued, so every L2 score is exact in f32: the ranks'
answers are identical to each other, to one process's four shards and to
the float64 oracle with the tombstone left out."""

import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

from metrovector_tpu import Builder, DataType, DistanceMetric, Reader
from metrovector_tpu.ops import numpy_oracle
from metrovector_tpu.parallel import DistributedSearcher as JaxDistributed
from metrovector_tpu.parallel import make_mesh as jax_mesh
from metrovector_tpu_torch import DeviceSpace
from metrovector_tpu_torch import Reader as PortReader
from metrovector_tpu_torch.parallel import (
    DistributedSearcher,
    ShardedDeviceSpace,
    initialize,
    load_space_sharded,
    make_mesh,
)
from metrovector_tpu_torch.parallel.distributed import global_mesh

WORKER = os.path.join(os.path.dirname(os.path.abspath(__file__)), "_torch_mp_worker.py")
WORKER_TIMEOUT = 60  # seconds: a hung rendezvous fails the test, not the suite


def cpu_mesh(n):
    return make_mesh(devices=["cpu"] * n)


@pytest.fixture
def space_file(tmp_path, rng):
    data = rng.integers(-8, 9, (900, 24)).astype(np.float32)
    b = Builder()
    b.add_vector_space("v", dim=24)
    b.add_vectors("v", data)
    b.delete_vector("v", 77)
    path = tmp_path / "d.mvt"
    b.build().save(path)
    return path, data


def _oracle(queries, data, k):
    mask = np.ones(len(data), np.float32)
    mask[77] = 0
    return numpy_oracle(queries, data, k, DistanceMetric.L2, valid_mask=mask)[1]


def test_initialize_does_nothing_in_one_process(monkeypatch):
    for var in ("WORLD_SIZE", "MASTER_ADDR", "RANK", "MASTER_PORT"):
        monkeypatch.delenv(var, raising=False)
    initialize()  # no address, no cluster environment: one process
    assert not torch.distributed.is_initialized()
    with pytest.raises(ValueError, match="together"):
        initialize("127.0.0.1:1")


def test_global_mesh_in_one_process():
    mesh = global_mesh(devices=["cpu"] * 4)
    assert mesh.group is None and mesh.world == 1 and mesh.first_shard() == 0
    assert mesh.shape == {"shard": 4}
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            global_mesh()  # every visible card by default: none here


def test_load_space_sharded_layout(space_file):
    path, data = space_file
    sp = PortReader.open(path).vector_space("v")
    dat, norms, mask, rowsums, per = load_space_sharded(sp, cpu_mesh(8))
    assert rowsums is None  # f32: no offset transform
    assert len(dat) == 8 and per * 8 >= 900 and all(t.shape[0] == per for t in dat)
    assert mask is not None and len(mask) == 8
    np.testing.assert_array_equal(torch.cat(dat).numpy()[:900, :24], data)
    np.testing.assert_array_equal(torch.cat(norms).numpy()[:900],
                                  np.asarray(sp.norms()[:900]))
    assert torch.cat(mask).numpy()[77] == 0 and torch.cat(mask).numpy().sum() == 899 + (
        sp.padded_rows - 900)


def test_uint8_recentred_slice_by_slice(tmp_path, rng):
    """uint8 codes recentred per slice (rows past num_valid zero) equal the
    resident upload's whole-block recentring, code sums too."""
    data = rng.integers(0, 256, (203, 20)).astype(np.float32)
    b = Builder()
    b.add_vector_space("u", dim=20, dtype=DataType.UINT8)
    b.add_vectors("u", data)
    path = tmp_path / "u.mvt"
    b.build().save(path)
    sp = PortReader.open(path).vector_space("u")
    dat, _, _, rowsums, per = load_space_sharded(sp, cpu_mesh(4), uint8_offset=True)
    whole = DeviceSpace.from_space(sp, device="cpu")
    rows = whole.data.shape[0]
    np.testing.assert_array_equal(torch.cat(dat).numpy()[:rows], whole.data.numpy())
    assert not torch.cat(dat).numpy()[rows:].any()
    np.testing.assert_array_equal(torch.cat(rowsums).numpy()[:rows], whole.rowsums.numpy())


def test_distributed_searcher_matches_jax_and_oracle(space_file, rng):
    path, data = space_file
    queries = rng.standard_normal((5, 24)).astype(np.float32)
    res = DistributedSearcher(PortReader.open(path).vector_space("v"), cpu_mesh(8)).search(
        queries, k=7)
    np.testing.assert_array_equal(res.indices, _oracle(queries, data, 7))
    want = JaxDistributed(Reader.open(path).vector_space("v"), jax_mesh(8)).search(
        queries, k=7, backend="xla")
    np.testing.assert_array_equal(res.indices, want.indices)
    np.testing.assert_allclose(res.distances, want.distances, rtol=1e-6)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_two_gloo_processes_match_each_other_and_the_oracle(space_file, tmp_path):
    """Two ranks of two CPU shards each: every rank holds only its own
    rows (checked in the worker), and both return the whole answer, the
    same as one process's four shards and as the oracle; the sharded
    stream and the dimension-sharded search (its partial dots summed by
    all_reduce) too."""
    path, data = space_file
    coord = f"127.0.0.1:{_free_port()}"
    outs = [tmp_path / f"rank{r}.json" for r in range(2)]
    env = {k: v for k, v in os.environ.items()
           if k not in ("WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT", "RANK")}
    procs = [subprocess.Popen([sys.executable, WORKER, coord, "2", str(r), str(path),
                               str(outs[r]), "2"], env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT)
             for r in range(2)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=WORKER_TIMEOUT)[0].decode(errors="replace"))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for r, p in enumerate(procs):
        assert p.returncode == 0, f"rank {r} failed:\n{logs[r]}"
    got = [json.loads(o.read_text()) for o in outs]
    assert [g["rank"] for g in got] == [0, 1]
    assert [g["shards"] for g in got] == [[0, 1], [2, 3]]
    for key in ("indices", "scores", "ids", "streamed", "streamed_scores", "dim_indices"):
        assert got[0][key] == got[1][key], key
    queries = np.random.default_rng(7).standard_normal((5, 24)).astype(np.float32)
    want = _oracle(queries, data, 9)
    for key in ("indices", "streamed", "dim_indices"):
        np.testing.assert_array_equal(np.asarray(got[0][key]), want)
    one = ShardedDeviceSpace(PortReader.open(path).vector_space("v"), cpu_mesh(4)).search(
        queries, k=9)
    np.testing.assert_array_equal(np.asarray(got[0]["scores"], np.float32), one.scores)
    np.testing.assert_array_equal(np.asarray(got[0]["streamed_scores"], np.float32),
                                  one.scores)
