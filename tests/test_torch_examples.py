"""The port's examples (``examples/torch_*.py``) against the JAX package's
(``examples/*.py``) on the CPU, at the JAX examples' own data, seeds and
sizes (``large_dataset`` at 2,000 x 64 with 8 queries, ``sharded_search``
on 8 CPU shards beside the conftest's 8 virtual devices), each run
in-process. Their printed lines must agree once times, rates, paths and
device names are masked (``examples/_answer_lines.py``): ids, titles,
file sizes in bytes and MB, sums and recalls exactly, the printed L2
values within one unit of their last printed digit (an f32 ulp of the
expanded form can round either way). ``multihost`` (two gloo ranks of its
own) is held to its own oracle assert; the README's port quick start runs
at 2,000 rows on the CPU. The PQ, IVF-PQ and serving examples are in
``test_torch_examples_search.py``."""

import importlib.util
import re
import sys
from pathlib import Path

import numpy as np
import pytest

import metrovector_tpu as jax_mvt
from metrovector_tpu import DistanceMetric

from _torch_parity import tolerance

REPO = Path(__file__).resolve().parent.parent
_spec = importlib.util.spec_from_file_location("answer_lines",
                                               REPO / "examples" / "_answer_lines.py")
lines = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(lines)

# name: (the JAX example's command line, the port's, loose lines)
CASES = {
    "simple": ([], [], ((r"L2=", lines.ULP),)),
    "similarity_search": ([], [], ()),
    "online_updates": ([], [], ()),
    "sharded_search": ([], ["--shards", "8"], ()),
    "sparse_and_filtered": ([], [], ()),
    "large_dataset": (["--vectors", "2000", "--dimensions", "64", "--queries", "8"],
                      ["--vectors", "2000", "--dimensions", "64", "--queries", "8"], ()),
}


def run_pair(name, monkeypatch, jax_argv=(), port_argv=()):
    """Both examples' printed lines, and the port's returned answers."""
    monkeypatch.setattr(sys, "argv", [name + ".py", *jax_argv])
    _, want = lines.captured(lines.load(name).main)
    out, got = lines.captured(lines.load("torch_" + name).main,
                              ["--device", "cpu", *port_argv])
    return out, got, want


@pytest.mark.parametrize("name", sorted(CASES))
def test_example_prints_the_jax_examples_answers(name, monkeypatch):
    jax_argv, port_argv, loose = CASES[name]
    _, got, want = run_pair(name, monkeypatch, jax_argv, port_argv)
    assert lines.compare(got, want, loose) == []


def test_data_types_prints_the_jax_lines_then_searches_each_type(monkeypatch, tmp_path):
    """The JAX example's lines first; then each space's top-3 through the
    device search, as JAX's ``SearchEngine`` gives it over the same file:
    indices identical, scores within ``_torch_parity.tolerance`` (the f32
    error of the expanded form, with every space's rows within rounding of
    the f32 ones)."""
    out, got, want = run_pair("data_types", monkeypatch)
    assert lines.compare(got[:len(want)], want) == []
    base = np.random.default_rng(0).standard_normal((100, 32)).astype(np.float32)
    names = ("f32", "f16", "bf16", "i8")
    b = jax_mvt.Builder()
    for name, dtype in zip(names, ("FLOAT32", "FLOAT16", "BFLOAT16", "INT8")):
        b.add_vector_space(name, dim=32, dtype=getattr(jax_mvt.DataType, dtype))
        b.add_vectors(name, base)
    b.build().save(tmp_path / "types.mvt")
    reader = jax_mvt.Reader.open(tmp_path / "types.mvt")
    extra = got[len(want):]
    assert len(extra) == len(names)
    for line, name in zip(extra, names):
        ref = jax_mvt.SearchEngine(reader.vector_space(name)).search(base[7:9], k=3)
        assert line == f"search {name:>5}: top-3 of rows 7, 8 -> {ref.indices.tolist()}"
        np.testing.assert_array_equal(out[name]["indices"], ref.indices)
        tol = tolerance(base[7:9], base, DistanceMetric.L2)[:, None]
        assert (np.abs(out[name]["scores"] - ref.scores) <= tol).all(), name


def test_multihost_two_gloo_ranks_on_the_cpu():
    out = lines.load("torch_multihost").main(["--device", "cpu"])
    assert out["backend"] == "gloo" and out["indices"].shape == (4, 5)


def test_readme_port_quick_start_executes(tmp_path, monkeypatch):
    readme = (REPO / "README.md").read_text()
    m = re.search(r"### Port quick start.*?```python\n(.*?)```", readme, re.S)
    assert m, "the port's quick-start block is missing from README.md"
    code = m.group(1).replace("100_000", "2_000")
    assert "mvt.SearchEngine(space)" in code
    code = code.replace("mvt.SearchEngine(space)", 'mvt.SearchEngine(space, device="cpu")')
    monkeypatch.chdir(tmp_path)
    ns: dict = {}
    exec(compile(code, "README-port-quickstart", "exec"), ns)
    assert (tmp_path / "docs.mvt").exists()
    assert len(ns["result"].top(0)) == 10
