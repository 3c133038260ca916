"""The ``gist1m`` deployment of the benchmark (``perfbench/configs/gist1m.json``,
1M × 960 f32 by L2 at ``high_verified``) on the CPU, at a small draw of its
generator through its normal path: ``gen/folded.py`` → ``program/dense_engine``
→ the bulk loop (``search_pipelined``) → the plain reference's checks under
the configuration's own limits, which planted faults and the TF32 and
bf16 controls fail. A planted corpus of ties on which the
certificate fails, falls back and stays correct, with its ``engine.fallback``
spans read by ``fallback_pct``; the generator's rows alike padded and not;
the cell's metrics; the readers ``high_scan_roofline`` and ``fallback_pct``
on synthetic traces and spans; ``roofline/high_verified.py`` at the cell's
sizes.

On the CPU ``precision="high"`` runs three f32 matmuls of the bf16 halves,
which agree with f32 to its rounding, so plain ``"high"`` cannot be shown to
fail the limits here: the card's control does that (``PERF.md`` §2)."""

import json
import time
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from metrovector_tpu_torch.utils import timing
from perfbench import core, tracing

ROOT = Path(__file__).resolve().parents[1]
CELL = "gist1m.bulk.b256.k10.high_verified"
SMALL = 20_000  # rows of the CPU draw; the cell holds 1,000,000
SEED = 2**31 + 17
US = 1000  # ns
START_S = 100.0
T0 = int(START_S * 1e9)


def _small_cfg(rows=SMALL):
    """The configuration with fewer rows and as many rows to a centre."""
    cfg = json.loads((ROOT / "perfbench" / "configs" / "gist1m.json").read_text())
    args = cfg["generator_args"]
    args["centres"] = max(1, round(args["centres"] * rows / cfg["rows"]))
    cfg["rows"] = rows
    return cfg


@pytest.fixture(scope="module")
def small_cell():
    """The cell with its configuration at 20,000 rows and its bulk traffic
    at batches of 16 from a pool of 4 (the CPU's plain versions take about
    a second for a batch of 256)."""
    cell = core.load_cell(CELL, ROOT)
    cell.config = _small_cfg()
    cell.traffic = dict(cell.traffic, batch=16, pool_batches=4)
    return cell


def _checked(cell, calls=8, build=None, wrap=None):
    """The cell's path on the CPU with a count of calls in place of the
    clock, so that a loaded host cannot leave the window empty: the inputs
    from the seed, the program's engine (or ``build``'s, wrapped by
    ``wrap``), ``calls`` batches of the bulk loop, and the harness's check
    of every answer. Returns ``(window, {check: (reading, limit)}, queries
    failed, engine)``."""
    cfg, t = cell.config, cell.traffic
    gen = core.load_module(ROOT, "gen", cfg["generator"])
    program = core.load_module(ROOT, "program", cfg["program"])
    loop = core.load_module(ROOT, "loops", t["loop"])
    cpu = torch.device("cpu")
    b = t["batch"]
    rows_alloc, width = program.layout(cfg)
    rows, q = gen.make(cfg, SEED, cpu, t["pool_batches"] * b, rows_alloc, width)
    pool = [np.ascontiguousarray(q[i * b:(i + 1) * b]) for i in range(t["pool_batches"])]
    engine = (build or program.build)(cfg, rows, cpu)
    if wrap is not None:
        engine = wrap(engine)
    win = loop.run(engine, pool, t["k"], lambda i, now: i >= calls, time.perf_counter)
    checks, failed = core.check_answers(cell, SEED, win, cpu, gen)
    return win, checks, failed, engine


# -- the configuration and its cell --------------------------------------------


def test_config_is_gist1m_as_published():
    cfg = json.loads((ROOT / "perfbench" / "configs" / "gist1m.json").read_text())
    assert (cfg["rows"], cfg["dim"], cfg["dtype"], cfg["metric"], cfg["precision"]) == (
        1_000_000, 960, "float32", "L2", "high_verified")
    assert cfg["reduced"] == [] and cfg["assumed"] and "GIST1M" in cfg["source"]
    assert cfg["peak"]["ops_per_s"] == 989e12 and cfg["peak"]["bytes_per_s"] == 3.35e12
    assert set(cfg["limits"]) == {"rank_gap", "dist_gap", "dup_ids"}
    assert cfg["limits"]["dup_ids"] == 0
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    entry = next(c for c in bench["configs"] if c["name"] == "gist1m")
    assert entry["file"] == "perfbench/configs/gist1m.json" and entry["reduced"] == []


def test_load_cell_reports_its_own_metrics():
    cell = core.load_cell(CELL, ROOT)
    assert cell.chips == 1 and cell.config["name"] == "gist1m"
    assert (cell.traffic["loop"], cell.traffic["batch"], cell.traffic["k"]) == ("bulk", 256, 10)
    assert (cell.traffic["pool_batches"], cell.traffic["warmup_batches"]) == (32, 32)
    assert sorted(m["name"] for m in cell.end_to_end) == ["p95_ms", "qps", "setup_s"]
    assert sorted(m["name"] for m in cell.per_layer) == ["fallback_pct", "high_scan_roofline"]


def test_small_draw_passes_the_limits_at_high_verified(small_cell):
    win, checks, failed, eng = _checked(small_cell)
    assert len(win.answers) == 8 and failed == 0
    assert list(checks) == ["rank_gap", "dist_gap", "dup_ids", "missing"]
    assert all(v <= lim for v, lim in checks.values()), checks
    assert eng.space.precision == "high_verified" and eng.space.dim == 960
    assert tuple(eng.space.data.shape) == (SMALL, 1024)  # padded as the port lays rows out
    stats = eng.verify_stats  # every query, certified or fallen back
    assert stats["certified"] + stats["fallbacks"] == 8 * 16


@pytest.mark.parametrize("fault", ["altered", "half_batch", "stale"])
def test_planted_faults_come_out_not_correct(small_cell, fault):
    from perfbench.tests.test_perfbench_harness import FAULTS

    _, checks, failed, _ = _checked(small_cell, wrap=FAULTS[fault])  # "altered": the 7th
    assert failed > 0 and any(v > lim for v, lim in checks.values())


@pytest.mark.parametrize("precision", ["tf32", "bf16"])
def test_lower_precision_controls_come_out_not_correct(small_cell, precision):
    from perfbench import control

    ref = core.load_module(ROOT, "reference", small_cell.config["reference"])
    _, checks, failed, _ = _checked(
        small_cell, calls=2,
        build=lambda cfg, rows, dev: control.ReferenceEngine(ref, cfg, rows, precision))
    assert failed > 0 and any(checks[n][0] > checks[n][1] for n in ("rank_gap", "dist_gap"))


# -- the certificate fails on planted ties, and the answer stays exact --------


def test_planted_ties_fall_back_stay_correct_and_read_in_fallback_pct():
    cfg = _small_cfg()
    gen = core.load_module(ROOT, "gen", cfg["generator"])
    program = core.load_module(ROOT, "program", cfg["program"])
    ref = core.load_module(ROOT, "reference", cfg["reference"])
    loop = core.load_module(ROOT, "loops", "bulk")
    cpu = torch.device("cpu")
    n, d = cfg["rows"], cfg["dim"]
    rows_alloc, width = program.layout(cfg)
    rows, q = gen.make(cfg, SEED, cpu, 32, rows_alloc, width)
    rng = np.random.default_rng(3)
    dup = rng.choice(n, 40, replace=False)
    rows[dup] = rows[dup[0]].clone()  # 40 rows alike: the fetch boundary ties the k-th
    # queries drawn around the copied row as the generator draws a row's
    # cluster mates, so that the 40 copies lead at the usual distances
    spread = cfg["generator_args"]["spread"]
    tied = np.abs(rows[dup[0], :d].numpy() + spread * rng.standard_normal((8, d)))
    tied = tied.astype(np.float32)
    pool = [tied, q[8:24]]
    engine = program.build(cfg, rows, cpu)
    timing.clear_spans()
    start = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU]):
        win = loop.run(engine, pool, 10, lambda i, now: i >= 4, time.perf_counter)
    seconds = time.perf_counter() - start + 1e-3
    kept = timing.spans()
    cell = core.load_cell(CELL, ROOT)
    run = core.RunData(cell=cell, setup_s=0.0, start=start, seconds=seconds, window=win,
                       roofline={}, trace=tracing.Trace(seconds * 1e6, 1.0, [], []))
    try:
        pct = core.load_module(ROOT, "metrics", "fallback_pct").read(run)
    finally:
        timing.clear_spans()
    assert engine.verify_stats["fallbacks"] >= 2 * 8  # each tied batch, both times

    expect = ref.answers(cfg, rows, pool, 10)
    for j, (ids, dist) in zip(win.pool, win.answers):
        exact = ref.distances_of(cfg, rows, pool[j], ids)
        per = ref.compare(cfg, ids, dist, *expect[j], exact)
        for name, lim in cfg["limits"].items():
            assert per[name].max() <= lim, (j, name)
    np.testing.assert_array_equal(win.answers[0][0], np.sort(dup)[None, :10].repeat(8, 0))

    fell = {s.batch for s in kept if s.name == "engine.fallback"}
    verified = {s.batch for s in kept if s.name == "engine.verify"}
    assert len(verified) == 4 and len(fell) >= 2 and fell <= verified
    finalize = {s.id: s for s in kept if s.name == "engine.finalize"}
    tied_batches = [finalize[s.parent].batch for s in kept
                    if s.name == "engine.readback" and s.parent in finalize]
    assert set(tied_batches[0::2]) <= fell  # the tied batch falls back each time
    assert pct == pytest.approx(100.0 * len(fell) / len(verified)) and pct >= 50.0


# -- the generator --------------------------------------------------------------


def test_generator_gives_the_same_rows_padded_and_unpadded():
    cfg = _small_cfg(3000)
    gen = core.load_module(ROOT, "gen", "folded")
    cpu = torch.device("cpu")
    n, d = cfg["rows"], cfg["dim"]
    a, qa = gen.make(cfg, 2**31 + 11, cpu, 64, n + 32, 1024)
    b, qb = gen.make(cfg, 2**31 + 11, cpu, 64, n, d)
    c, qc = gen.make(cfg, 5, cpu, 64, n, d)
    assert torch.equal(a[:n, :d], b) and np.array_equal(qa, qb)
    assert not a[n:].any() and not a[:, d:].any()
    assert not torch.equal(b, c) and not np.array_equal(qa, qc)
    assert b.dtype == torch.float32 and qa.dtype == np.float32 and qa.shape == (64, d)
    # non-negative reals: no exact zero, hardly a value bf16 holds exactly
    assert float(b.min()) > 0 and float(qa.min()) > 0
    assert (b.bfloat16().float() == b).float().mean() < 0.01
    with pytest.raises(ValueError, match="float32"):
        gen.make(dict(cfg, dtype="int8"), 1, cpu, 4, n, d)


# -- the readers ----------------------------------------------------------------

HIGH = "void (anonymous namespace)::high_scan_kernel<32>(unsigned char const*, CUtensorMap)"
SPLIT = "(anonymous namespace)::split_queries_kernel(float const*, long, long, int)"
FFMA = "void (anonymous namespace)::scan_kernel<float, 32, false, float>(float const*)"
MERGE = "(anonymous namespace)::warp_merge_kernel(float const*, int const*)"


def _run(trace, batches=10, spans_start=START_S):
    cell = core.load_cell(CELL, ROOT)
    roof = core.load_module(ROOT, "roofline", "high_verified").per_batch(cell.config,
                                                                       cell.traffic)
    win = core.Window(taken=[0.0] * batches)
    return core.RunData(cell=cell, setup_s=0.0, start=spans_start, seconds=1.0, window=win,
                        roofline=roof, trace=trace)


def test_high_scan_roofline_reads_the_bf16x3_kernels_alone():
    reader = core.load_module(ROOT, "metrics", "high_scan_roofline")
    # 10 batches: 46.9 ms of scan, 0.1 of split, beside a fallback and merges
    ops = [(FFMA, 150_000.0), (HIGH, 46_900.0), (MERGE, 200.0), (SPLIT, 100.0),
           ("Memcpy DtoH (Device -> Pinned)", 80.0)]
    run = _run(tracing.Trace(2e6, 197_280.0, ops, []))
    want = 100.0 * run.roofline["seconds"] / (47_000.0 * 1e-6 / 10)
    assert reader.read(run) == pytest.approx(want, rel=1e-12)
    assert reader.read(run) == pytest.approx(31.7, abs=0.1)
    # names as some tools write them, with underscores for the punctuation
    ops_u = [("void__anonymous_namespace_::high_scan_kernel_32_", 46_900.0),
             ("_anonymous_namespace_::split_queries_kernel_float", 100.0)]
    assert reader.read(_run(tracing.Trace(2e6, 1.0, ops_u, []))) == pytest.approx(want)
    # no bf16x3 kernel ran, no trace, no batch: nothing to read
    assert reader.read(_run(tracing.Trace(2e6, 150_000.0, [(FFMA, 150_000.0)], []))) is None
    assert reader.read(_run(None)) is None
    assert reader.read(_run(tracing.Trace(2e6, 1.0, ops, []), batches=0)) is None


def _spans(layout):
    """``engine.verify`` for each batch, ``engine.fallback`` for those in
    ``fell``, as ``Span``s on the window's clock."""
    ids = iter(range(1, 10**6))
    out = []
    for b, (verify, fell) in layout.items():
        t = 1000 + 1000 * b
        fin = next(ids)
        out.append(timing.Span(fin, "engine.finalize", T0 + t * US, T0 + (t + 900) * US,
                               None, 1, b))
        rb = next(ids)
        out.append(timing.Span(rb, "engine.readback", T0 + (t + 10) * US,
                               T0 + (t + 800) * US, fin, 1, b))
        if verify:
            out.append(timing.Span(next(ids), "engine.verify", T0 + (t + 20) * US,
                                   T0 + (t + 30) * US, rb, 1, b))
        if fell:
            out.append(timing.Span(next(ids), "engine.fallback", T0 + (t + 40) * US,
                                   T0 + (t + 700) * US, rb, 1, b))
    return sorted(out, key=lambda s: s.start_ns)


@pytest.mark.parametrize("layout,want", [
    ({0: (True, False), 1: (True, True), 2: (True, False), 3: (True, True)}, 50.0),
    ({0: (True, True)}, 100.0),
    ({0: (True, False), 1: (True, False)}, 0.0),
    ({0: (True, False), 1: (False, True)}, 0.0),  # a re-run of no verified batch
    ({0: (False, False), 1: (False, False)}, None),  # no certificate: a plain precision
    ({}, None),
])
def test_fallback_pct_reads_the_share_of_verified_batches(monkeypatch, layout, want):
    spans = _spans(layout)
    monkeypatch.setattr(timing, "spans", lambda: spans)
    reader = core.load_module(ROOT, "metrics", "fallback_pct")
    got = reader.read(_run(tracing.Trace(1e6, 1.0, [], [])))
    assert got == (None if want is None else pytest.approx(want))
    # no card traced, or spans outside the window: nothing
    assert reader.read(_run(tracing.Trace(1e6, 0.0, [], []))) is None
    assert reader.read(_run(tracing.Trace(1e6, 1.0, [], []), spans_start=START_S + 2)) is None


def test_fallback_pct_reads_nothing_from_a_program_without_spans(monkeypatch):
    monkeypatch.delattr(timing, "spans")
    reader = core.load_module(ROOT, "metrics", "fallback_pct")
    assert reader.read(_run(tracing.Trace(1e6, 1.0, [], []))) is None


def test_high_verified_roofline_at_the_cells_sizes():
    cell = core.load_cell(CELL, ROOT)
    roof = core.load_module(ROOT, "roofline", "high_verified")
    r = roof.per_batch(cell.config, cell.traffic)
    peak = cell.config["peak"]
    assert r["ops"] == 6 * 256 * 1_000_000 * 960
    assert r["bytes"] == 1_000_000 * 960 * 4 + 4 * 1_000_000 + 256 * 960 * 4 + 256 * 18 * 8
    assert r["ops"] / peak["ops_per_s"] * 1e3 == pytest.approx(1.490961, rel=1e-6)
    assert r["bytes"] / peak["bytes_per_s"] * 1e3 == pytest.approx(1.147767, rel=1e-6)
    assert r["bound"] == "ops" and r["seconds"] == pytest.approx(1.490961e-3, rel=1e-6)
    assert roof.KERNELS == ("split_queries_kernel", "high_scan_kernel")
    with pytest.raises(ValueError):
        roof.per_batch(dict(cell.config, dtype="int8"), cell.traffic)
