"""Execute the port's public-API docstring examples: the mirror of
``tests/test_doctests.py`` over ``metrovector_tpu_torch``'s modules of the
same names, each example on the CPU."""

import doctest
import importlib

import pytest

MODULES = [
    "metrovector_tpu_torch.database",
    "metrovector_tpu_torch.format.builder",
    "metrovector_tpu_torch.format.reader",
    "metrovector_tpu_torch.vectors.space",
    "metrovector_tpu_torch.engine",
]


@pytest.mark.parametrize("modname", MODULES)
def test_module_doctests(modname):
    results = doctest.testmod(
        importlib.import_module(modname),
        optionflags=doctest.ELLIPSIS | doctest.NORMALIZE_WHITESPACE,
        verbose=False,
    )
    assert results.attempted > 0, f"{modname} has no executable examples"
    assert results.failed == 0
