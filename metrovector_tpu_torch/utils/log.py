"""Library logging.

The reference has no logging at all — just stray debug ``eprintln!`` left
in production code (``src/reader.rs:200-207`` in thegenem0/metrovector,
noted in SURVEY.md §5). Here: standard-library loggers under the
``metrovector_tpu_torch`` namespace, silent by default (NullHandler), opt-in via
``MVT_LOG=debug`` or normal ``logging`` configuration.
"""

from __future__ import annotations

import logging
import os

_ROOT = logging.getLogger("metrovector_tpu_torch")
_ROOT.addHandler(logging.NullHandler())

_level = os.environ.get("MVT_LOG")
if _level:
    logging.basicConfig()
    _ROOT.setLevel(getattr(logging, _level.upper(), logging.INFO))


def get_logger(name: str) -> logging.Logger:
    """A child logger, e.g. ``get_logger("engine")`` →
    ``metrovector_tpu_torch.engine``."""
    return _ROOT.getChild(name)
