"""The port's PQ, IVF-PQ and serving examples against the JAX package's
on the CPU (``examples/torch_{quantized_search,serving}.py`` and their
``examples/*.py``), each run
in-process at the JAX example's own data, seeds and sizes; the rule of
``test_torch_examples.py``. On the CPU the port's k-means draws the
reference's samples in the reference's order and its float sums agree,
so the PQ and IVF-PQ recalls and the scan mode's agreement are held
exactly as printed, with no band."""

import importlib.util
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent
_spec = importlib.util.spec_from_file_location("answer_lines",
                                               REPO / "examples" / "_answer_lines.py")
lines = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(lines)


@pytest.mark.parametrize("name", ["quantized_search", "serving"])
def test_example_prints_the_jax_examples_answers(name, monkeypatch):
    monkeypatch.setattr(sys, "argv", [name + ".py"])
    _, want = lines.captured(lines.load(name).main)
    _, got = lines.captured(lines.load("torch_" + name).main, ["--device", "cpu"])
    assert lines.compare(got, want) == []
