"""``python -m metrovector_tpu_torch`` against ``python -m metrovector_tpu``
on the same files: the mirror of ``tests/test_cli.py``. ``info``,
``validate`` and ``head`` print what the JAX CLI prints; ``search`` (with
``--device cpu``: the plain versions) gives its rows and ids, and
distances within the f32 band; ``tune`` has nothing to time on the CPU and
exits 1 with one line, as does a bad path, a wrong query width, a JAX
tile flag, or a CUDA device on a machine without one."""

import json

import numpy as np
import pytest
import torch

import metrovector_tpu_torch.utils.tune as tune_mod
from metrovector_tpu import Builder, DataType, VectorType
from metrovector_tpu.__main__ import main as jax_main
from metrovector_tpu_torch import Database, Reader
from metrovector_tpu_torch.__main__ import main
from metrovector_tpu_torch.ops.grid import Grid


@pytest.fixture
def mixed_file(tmp_path, rng):
    b = Builder()
    b.add_vector_space("dense", dim=8, dtype=DataType.FLOAT32)
    data = rng.standard_normal((40, 8)).astype(np.float32)
    b.add_vectors("dense", data)
    b.set_vector_ids("dense", np.arange(100, 140, dtype=np.uint64))
    b.add_metadata_column("dense", "tag", [f"t{i}" for i in range(40)])
    b.delete_vector("dense", 3)
    b.add_vector_space("sp", dim=32, vector_type=VectorType.SPARSE)
    b.add_sparse_vectors(
        "sp",
        [(rng.choice(32, 4, replace=False),
          rng.standard_normal(4).astype(np.float32)) for _ in range(20)],
    )
    path = tmp_path / "cli.mvt"
    b.build().save(path)
    return str(path), data


def _both(capsys, argv, port_extra=()):
    """(rc, stdout) of the JAX CLI and of the port's on the same argv."""
    rc_j = jax_main(list(argv))
    out_j = capsys.readouterr().out
    rc_p = main(list(argv) + list(port_extra))
    out_p = capsys.readouterr().out
    return (rc_j, out_j), (rc_p, out_p)


@pytest.mark.parametrize("argv", [
    ["info"], ["validate"], ["validate", "--checksum"],
    ["head", "-s", "dense", "-n", "2"], ["head", "-s", "sp", "-n", "3"],
])
def test_host_commands_print_what_the_jax_cli_prints(mixed_file, capsys, argv):
    path, _ = mixed_file
    (rc_j, out_j), (rc_p, out_p) = _both(capsys, argv[:1] + [path] + argv[1:])
    assert rc_j == rc_p == 0
    assert out_p == out_j


def test_cli_info(mixed_file, capsys):
    path, _ = mixed_file
    assert main(["info", path]) == 0
    out = capsys.readouterr().out
    assert "2 space(s)" in out
    assert "dense: 40 x 8 float32 dense, metric=l2" in out
    assert "sp: 20 x 32 float32 sparse" in out
    assert "stable u64 ids: yes" in out and "tombstones: 1 deleted" in out
    assert "metadata: tag" in out


def test_cli_validate_flags_a_corrupt_byte(mixed_file, tmp_path, capsys):
    path, _ = mixed_file
    raw = bytearray(open(path, "rb").read())
    raw[len(raw) // 3] ^= 0xFF
    bad = tmp_path / "bad.mvt"
    bad.write_bytes(bytes(raw))
    (rc_j, out_j), (rc_p, out_p) = _both(capsys, ["validate", str(bad), "--checksum"])
    assert rc_j == rc_p == 1 and out_p == out_j and out_p.startswith("INVALID")


@pytest.mark.parametrize("space", ["dense", "sp"])
def test_cli_search_matches_the_jax_cli(mixed_file, tmp_path, capsys, space):
    path, data = mixed_file
    dim = 8 if space == "dense" else 32
    q = np.random.default_rng(4).standard_normal((3, dim)).astype(np.float32)
    if space == "dense":
        q[0] = data[7]
    qf = tmp_path / "q.npy"
    np.save(qf, q)
    argv = ["search", path, "-q", str(qf), "-s", space, "-k", "5"]
    (rc_j, out_j), (rc_p, out_p) = _both(capsys, argv, ["--device", "cpu"])
    assert rc_j == rc_p == 0
    got = [json.loads(line) for line in out_p.strip().splitlines()]
    want = [json.loads(line) for line in out_j.strip().splitlines()]
    assert [g["query"] for g in got] == [0, 1, 2]
    for g, w in zip(got, want):
        assert [r["row"] for r in g["results"]] == [r["row"] for r in w["results"]]
        assert [r["id"] for r in g["results"]] == [r["id"] for r in w["results"]]
        np.testing.assert_allclose([r["distance"] for r in g["results"]],
                                   [r["distance"] for r in w["results"]],
                                   rtol=1e-5, atol=1e-3)
    if space == "dense":
        top = got[0]["results"][0]
        assert top["row"] == 7 and top["id"] == 107
        assert top["distance"] == pytest.approx(0.0, abs=1e-3)


def test_cli_errors_are_one_line(mixed_file, tmp_path, capsys):
    path, _ = mixed_file
    qf = tmp_path / "q.npy"
    np.save(qf, np.zeros((2, 5), np.float32))  # the dense space has dim 8
    cases = [
        ["search", path, "-q", str(qf), "-s", "dense", "--device", "cpu"],
        ["search", str(tmp_path / "missing.mvt"), "-q", str(qf), "--device", "cpu"],
        ["info", str(tmp_path / "missing.mvt")],
        ["tune", path, "-s", "dense", "--device", "cpu"],  # nothing to time on the CPU
        ["tune", path, "-s", "dense", "--block-rows", "512"],  # the JAX package's tile
        ["tune", path, "-s", "dense", "--query-tile", "128"],
        ["tune", path, "-s", "dense", "--index", "--device", "cpu"],
    ]
    if not torch.cuda.is_available():
        cases.append(["search", path, "-q", str(qf), "-s", "dense"])  # cuda by default
    for argv in cases:
        assert main(argv) == 1, argv
        captured = capsys.readouterr()
        assert captured.out == ""
        lines = captured.err.strip().splitlines()
        assert len(lines) == 1 and lines[0].startswith("error: "), (argv, captured.err)
    # space disambiguation, as in the JAX CLI
    with pytest.raises(SystemExit):
        main(["head", path])
    with pytest.raises(SystemExit):
        main(["head", path, "-s", "nope"])


def test_cli_tune_save_persists_and_a_database_adopts(mixed_file, tmp_path, capsys,
                                                     monkeypatch):
    """The ``tune`` flow with the CUDA check and the timings substituted
    (three timings a candidate, best of): the report fastest first, the
    applied grid, and with ``--save`` a hint that a fresh ``Database``
    adopts."""
    from metrovector_tpu.index import encode_pq, train_pq

    path, _ = mixed_file
    monkeypatch.setattr(tune_mod, "require_kernels", lambda device, what: None)
    times = iter([0.006, 0.005, 0.007, 0.003, 0.001, 0.002] + [0.01] * 40)
    monkeypatch.setattr(tune_mod, "measure_once", lambda run: (run(), next(times))[1])
    assert main(["tune", path, "-s", "dense", "-k", "3", "--batch", "4",
                 "--waves", "0.5,1,2", "--save", "--device", "cpu"]) == 0
    lines = [json.loads(x) for x in capsys.readouterr().out.strip().splitlines()]
    report = [r for r in lines if "waves" in r]
    assert [r["waves"] for r in report] == [1.0, 0.5, 2.0]
    assert lines[-1] == {"applied": {"waves": 1.0, "tile": None}, "saved": True}
    assert Database.open(path, device="cpu").engine("dense").grid == Grid(1.0, None)

    # sparse spaces route to the ELL engine, whose tiles are candidates
    assert main(["tune", path, "-s", "sp", "-k", "2", "--batch", "4", "--waves", "4",
                 "--tiles", "auto,32", "--device", "cpu"]) == 0
    lines = [json.loads(x) for x in capsys.readouterr().out.strip().splitlines()]
    assert sorted(str(r["tile"]) for r in lines if "waves" in r) == ["32", "None"]
    assert lines[-1]["applied"]["waves"] == 4.0 and lines[-1]["saved"] is False

    # --index tunes the persisted PQ sidecar, saved under "adc"
    rng = np.random.default_rng(2)
    x = rng.standard_normal((256, 16)).astype(np.float32)
    books = train_pq(x, m=4, ksub=16, iters=2, seed=0)
    b = Builder()
    b.add_vector_space("v", dim=16)
    b.add_vectors("v", x)
    b.set_pq_index("v", books, encode_pq(x, books))
    pq_path = str(tmp_path / "pq.mvt")
    b.build().save(pq_path)
    assert main(["tune", pq_path, "--index", "-k", "5", "--batch", "8", "--waves", "2",
                 "--tiles", "auto,4", "--save", "--device", "cpu"]) == 0
    lines = [json.loads(x) for x in capsys.readouterr().out.strip().splitlines()]
    saved = Reader.open(pq_path).manifest.hints["tuned"]["v"]["adc"]["cuda"]
    assert saved == lines[-1]["applied"]
    assert Database.open(pq_path, device="cpu").pq_index("v").grid == as_tuple(saved)
    # K1 holds one tile
    assert main(["tune", path, "-s", "dense", "--tiles", "32", "--device", "cpu"]) == 1
    assert "one block tile" in capsys.readouterr().err


def as_tuple(saved: dict) -> Grid:
    return Grid(saved["waves"], saved["tile"])
