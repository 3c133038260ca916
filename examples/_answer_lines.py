"""The printed answers of two runs of an example, compared line by line.

An example prints its answers (top ids, titles, L2 values, recalls, file
sizes, sums) beside what varies from run to run. :func:`masked` blanks
only the latter: times, rates, paths and device names, and the counts of a
``MicroBatcher``'s launches and drain windows, which depend on when its
client threads' requests arrive. :func:`compare` then holds every other
character equal, except on lines that match a ``loose`` pattern, whose
numbers compare within that pattern's tolerance.
"""

from __future__ import annotations

import contextlib
import importlib.util
import io
import os
import re

_MASKS = (
    (re.compile(r"(?<!\S)/\S+"), "<path>"),
    (re.compile(r"\b(cpu|cuda(:\d+)?)\b"), "<device>"),
    (re.compile(r"[\d,]+(\.\d+)? (QPS|vectors/s)"), r"<rate> \2"),
    (re.compile(r"\d+(\.\d+)? ?ms\b"), "<ms>"),
    (re.compile(r"in \d+ launches \(occupancy \d+%"), "in <n> launches (occupancy <n>%"),
    (re.compile(r"-> \d+ launches over \d+ drain windows"),
     "-> <n> launches over <n> drain windows"),
)
_NUMBER = re.compile(r"-?\d+(?:\.\d+)?")
# PhaseTimer.report(): one line a phase, ordered by its time.
_REPORT_ROW = re.compile(r"^(\S.*?)\s+<ms>\s+(\d+)\s+\d+(\.\d+)?%$")
ULP = "one unit in the last printed digit"


def load(name: str):
    """The example ``examples/<name>.py`` as a module of its own (the
    examples are scripts, not a package)."""
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), name + ".py")
    spec = importlib.util.spec_from_file_location(f"example_{name}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def captured(fn, *args, **kw) -> tuple[object, list[str]]:
    """``fn(*args, **kw)``'s result and the lines it printed."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = fn(*args, **kw)
    return out, buf.getvalue().splitlines()


def masked(lines: list[str]) -> list[str]:
    """``lines`` with times, rates, paths and device names blanked; a
    ``PhaseTimer`` report's rows (ordered by time) sorted by phase."""
    out = []
    for line in lines:
        for pattern, repl in _MASKS:
            line = pattern.sub(repl, line)
        out.append(line)
    rows = [i for i, line in enumerate(out) if _REPORT_ROW.match(line)]
    if rows:
        names = sorted(_REPORT_ROW.sub(r"\1 calls \2", out[i]) for i in rows)
        for i, name in zip(rows, names):
            out[i] = name
    return out


def _close(a: str, b: str, tol) -> bool:
    if tol == ULP:
        tol = 10.0 ** -len(a.partition(".")[2])
    elif isinstance(tol, tuple):  # (for numbers with a decimal point, for integers)
        tol = tol[0] if "." in a else tol[1]
    return abs(float(a) - float(b)) <= tol * (1 + 1e-9)


def compare(got: list[str], want: list[str], loose=()) -> list[str]:
    """The differences between two runs' masked lines, as messages (empty
    when they agree). ``loose``: ``(regex, tolerance)`` pairs; on a line
    that matches, the numbers need only agree within the tolerance (a
    float; a pair, for numbers with a decimal point and for integers; or
    :data:`ULP`) and the rest of the line exactly."""
    got, want = masked(got), masked(want)
    if len(got) != len(want):
        return [f"{len(got)} lines against {len(want)}:\n" + "\n".join(got)
                + "\n----\n" + "\n".join(want)]
    bad = []
    for g, w in zip(got, want):
        if g == w:
            continue
        tol = next((t for pattern, t in loose if re.search(pattern, w)), None)
        gn, wn = _NUMBER.findall(g), _NUMBER.findall(w)
        if (tol is None or _NUMBER.sub("#", g) != _NUMBER.sub("#", w)
                or len(gn) != len(wn)
                or not all(_close(a, b, tol) for a, b in zip(gn, wn))):
            bad.append(f"{g!r} != {w!r}")
    return bad
