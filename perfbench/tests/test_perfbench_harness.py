"""The benchmark harness on the CPU: its files against the contract's rules,
the generators, the rooflines, the reference against a NumPy brute force,
whole runs of small cells (sound, with faults planted, with the controls in
the program's place), a cell added as new files only, the trace's
reduction, the refusal without a card, and that no run loads JAX, the JAX
package or (in the reference) the program."""

import hashlib
import json
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from perfbench import control, core, tracing

ROOT = Path(__file__).resolve().parents[2]
PB = ROOT / "perfbench"
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}\Z")
UNIT = re.compile(r"[A-Za-z0-9_/%.-]{1,16}\Z")
CELLS = [w["name"] for w in BENCH["workloads"]]
SMALL_ROWS = {"sift1m": 3000, "msspacev10m": 9000}
CONFIGS = sorted(SMALL_ROWS)


# -- faults planted under a run: each wraps the engine and breaks its answers


class _Fault:
    def __init__(self, engine):
        self.engine = engine
        self.calls = 0

    def search(self, queries, k=10):
        self.calls += 1
        return self.broken(queries, k, self.engine.search(queries, k))

    def search_pipelined(self, batches, k=10):
        for q in batches:
            yield self.search(q, k)


class Altered(_Fault):
    """One row id of every seventh answer changed where it is produced."""

    def broken(self, queries, k, res):
        if self.calls % 7:
            return res
        ids = np.array(res.indices)
        ids[0, 0] += 1
        return control.Answer(ids, res.distances)


class HalfBatch(_Fault):
    """Half of each batch left out: its queries get the other half's
    answers."""

    def broken(self, queries, k, res):
        res = self.engine.search(queries[:len(queries) // 2], k)
        return control.Answer(np.concatenate([res.indices] * 2)[:len(queries)],
                              np.concatenate([res.distances] * 2)[:len(queries)])


class Stale(_Fault):
    """The state left unchanged: every call answers with the first call's
    answer."""

    first = None

    def broken(self, queries, k, res):
        if self.first is None:
            self.first = res
        return self.first


FAULTS = {"altered": Altered, "half_batch": HalfBatch, "stale": Stale}


def _line(text) -> bool:
    return isinstance(text, str) and 1 <= len(text) <= 200 and "\n" not in text \
        and "\t" not in text


# -- the files -------------------------------------------------------------


def test_benchmark_json_keys_names_and_units():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["perfbench"]
    assert BENCH["command"] == ["python3", "perfbench/run.py"]
    assert 1 <= BENCH["run_seconds"] <= 51
    names = set()
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and _line(c["source"]) and _line(c["why"])
        assert c["file"].startswith("perfbench/") and (ROOT / c["file"]).is_file()
        assert c["reduced"] == json.loads((ROOT / c["file"]).read_text())["reduced"]
        names.add(c["name"])
    metrics = {}
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]), m
        assert m["better"] in ("lower", "higher")
        assert m["name"] not in metrics
        metrics[m["name"]] = m
        assert (PB / "metrics" / f"{m['name']}.py").is_file()
        assert set(m.get("workloads", CELLS)) <= set(CELLS)
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e
    for m in BENCH["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["moves"] in e2e and _line(m["layer"])
        for w in m["workloads"]:  # each cell listed reports the metric it moves
            assert metrics[m["moves"]].get("workloads", [w]).count(w) == 1
    pairs = set()
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"]) and _line(w["why"])
        assert w["config"] in names and w["chips"] == 1
        assert (PB / "traffic" / f"{w['traffic']}.json").is_file()
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))


@pytest.mark.parametrize("config", CONFIGS)
def test_config_files_name_their_parts(config):
    cfg = json.loads((PB / "configs" / f"{config}.json").read_text())
    assert cfg["name"] == config and cfg["reduced"] == [] and cfg["assumed"]
    for kind, key in (("gen", "generator"), ("program", "program"),
                      ("reference", "reference"), ("roofline", "roofline")):
        assert (PB / kind / f"{cfg[key]}.py").is_file()
    lim = cfg["limits"]
    assert lim["dup_ids"] == 0 and lim["dist_gap"] > 0
    assert set(lim) <= {"wrong_ids", "rank_gap", "dist_gap", "dup_ids"}
    # integer data is exact in f32: its ranks are held exactly
    assert lim.get("wrong_ids", 0) == 0 and ("wrong_ids" in lim) == (cfg["dtype"] == "int8")
    assert cfg["peak"]["bytes_per_s"] == 3.35e12


@pytest.mark.parametrize("traffic", sorted(p.stem for p in (PB / "traffic").glob("*.json")))
def test_traffic_files_parse(traffic):
    t = json.loads((PB / "traffic" / f"{traffic}.json").read_text())
    assert (PB / "loops" / f"{t['loop']}.py").is_file()
    assert t["clients"] == 1 and t["filter"] is None
    assert t["batch"] > 0 and t["k"] > 0 and t["pool_batches"] > 0


# -- generators, rooflines, the reference -----------------------------------


def _small(config, rows=None):
    """The configuration with fewer rows and as many rows to a centre."""
    cfg = json.loads((PB / "configs" / f"{config}.json").read_text())
    small = rows or SMALL_ROWS[config]
    args = cfg["generator_args"]
    args["centres"] = max(1, round(args["centres"] * small / cfg["rows"]))
    cfg["rows"] = small
    return cfg


@pytest.mark.parametrize("config", CONFIGS)
def test_generators_repeat_by_seed(config):
    cfg = _small(config)
    gen = core.load_module(ROOT, "gen", cfg["generator"])
    cpu = torch.device("cpu")
    n, d = cfg["rows"], cfg["dim"]
    a, qa = gen.make(cfg, 2**31 + 11, cpu, 64, n + 32, 128)
    b, qb = gen.make(cfg, 2**31 + 11, cpu, 64, n, d)
    c, qc = gen.make(cfg, 5, cpu, 64, n, d)
    assert torch.equal(a[:n, :d], b) and np.array_equal(qa, qb)
    assert not torch.equal(b, c) and not np.array_equal(qa, qc)
    assert not a[n:].any() and not a[:, d:].any()
    assert qa.dtype == np.float32 and qa.shape == (64, d)
    assert torch.equal(b.float(), b.float().round())
    args = cfg["generator_args"]
    assert qa.min() >= args["lo"] and qa.max() <= args["hi"]
    assert np.array_equal(qa, np.rint(qa)) == args["round_queries"]
    if cfg["dtype"] == "int8":  # the batch spans the int8 range, as the engine's scale needs
        assert np.abs(qa).max() == 127 and int(b.abs().max()) == 127


# ops bound, bytes bound, which bounds one batch. Bytes: the logical rows,
# 4 B a row of norms for L2, f32 queries, 8 B an answer; ms at 67 TFLOP/s
# (f32) or 1,979 TOP/s (int8) and 3.35 TB/s.
WORKED_MS = {
    "sift1m.bulk.b256.k10": (0.978149, 0.154075, "ops"),   # 516,151,552 B
    "sift1m.bulk.b128.k100": (0.489075, 0.154080, "ops"),  # 516,167,936 B
    "sift1m.online.b32.k10": (0.122269, 0.154035, "bytes"),  # 516,018,944 B
    "msspacev10m.bulk.b128.k10": (0.129358, 0.310466, "bytes"),  # 1,040,061,440 B
}


@pytest.mark.parametrize("cell", CELLS)
def test_roofline_worked_bounds(cell):
    c = core.load_cell(cell, ROOT)
    r = core.load_module(ROOT, "roofline", c.config["roofline"]).per_batch(c.config, c.traffic)
    ops_ms, bytes_ms, bound = WORKED_MS[cell]
    peak = c.config["peak"]
    assert r["ops"] / peak["ops_per_s"] * 1e3 == pytest.approx(ops_ms, rel=1e-5)
    assert r["bytes"] / peak["bytes_per_s"] * 1e3 == pytest.approx(bytes_ms, rel=1e-5)
    assert r["bound"] == bound and r["seconds"] * 1e3 == pytest.approx(max(ops_ms, bytes_ms), rel=1e-4)


def _brute_force(cfg, rows, q, k):
    """NumPy f64: (ids, distances), ties to the lowest row."""
    x = rows.numpy().astype(np.float64) * cfg.get("scale", 1.0)
    q = q.astype(np.float64)
    if cfg["metric"] == "L2":
        cost = ((q[:, None, :] - x[None]) ** 2).sum(-1)
    else:
        cost = -(q @ x.T)
    order = np.lexsort((np.broadcast_to(np.arange(len(x)), cost.shape), cost), axis=1)[:, :k]
    best = np.take_along_axis(cost, order, 1)
    return order, np.sqrt(best) if cfg["metric"] == "L2" else -best


@pytest.mark.parametrize("metric", ["L2", "INNER_PRODUCT"])
@pytest.mark.parametrize("config", CONFIGS)
@pytest.mark.parametrize("k", [1, 10, 37])
def test_reference_matches_numpy_brute_force_with_ties(config, metric, k):
    cfg = _small(config, rows=600)
    cfg["metric"] = metric
    gen = core.load_module(ROOT, "gen", cfg["generator"])
    ref = core.load_module(ROOT, "reference", "exact_topk")
    rows, q = gen.make(cfg, 7, torch.device("cpu"), 40, 600, cfg["dim"])
    rows[300:400] = rows[200:300]  # equal rows: every distance ties
    q[5] = rows[250].numpy() * (cfg.get("scale", 1.0))
    old = ref.ROW_BLOCK
    ref.ROW_BLOCK = 128  # several blocks, ties across them
    try:
        got = ref.answers(cfg, rows, [q[:17], q[17:]], k)
    finally:
        ref.ROW_BLOCK = old
    ids = np.concatenate([g[0] for g in got])
    dist = np.concatenate([g[1] for g in got])
    want = [_brute_force(cfg, rows, part, k) for part in (q[:17], q[17:])]
    np.testing.assert_array_equal(ids, np.concatenate([w[0] for w in want]))
    np.testing.assert_allclose(dist, np.concatenate([w[1] for w in want]), rtol=1e-12)


@pytest.mark.parametrize("config", CONFIGS)
def test_reference_judges_served_rows_by_their_exact_distance(config):
    cfg = _small(config, rows=500)
    gen = core.load_module(ROOT, "gen", cfg["generator"])
    ref = core.load_module(ROOT, "reference", "exact_topk")
    rows, q = gen.make(cfg, 8, torch.device("cpu"), 6, 500, cfg["dim"])
    [(ids, dist)] = ref.answers(cfg, rows, [q], 5)
    exact = ref.distances_of(cfg, rows, q, ids)
    np.testing.assert_allclose(exact, dist, rtol=1e-12)
    per = ref.compare(cfg, ids, dist, ids, dist, exact)
    assert not per["wrong_ids"].any() and not per["dup_ids"].any()
    assert per["rank_gap"].max() < 1e-12 and per["dist_gap"].max() < 1e-12
    # ranks 2..6 served for 1..5, each with its own exact distance
    [(ids6, dist6)] = ref.answers(cfg, rows, [q], 6)
    moved, moved_d = ids6[:, 1:], dist6[:, 1:]
    per = ref.compare(cfg, moved, moved_d, ids, dist, ref.distances_of(cfg, rows, q, moved))
    assert (per["wrong_ids"] > 0).all() and (per["rank_gap"] > 0).all()
    assert per["dist_gap"].max() < 1e-12 and not per["dup_ids"].any()
    # a row repeated, and an id that names no row
    bad = ids.copy()
    bad[0, 1] = bad[0, 0]
    bad[1, 2] = -1
    per = ref.compare(cfg, bad, dist, ids, dist, ref.distances_of(cfg, rows, q, bad))
    assert per["dup_ids"][:2].tolist() == [1, 1] and np.isinf(per["rank_gap"][1])


# -- whole runs of small cells on the CPU ------------------------------------


@pytest.fixture(scope="module")
def small_root(tmp_path_factory):
    """A copy of the benchmark whose configurations hold fewer rows, and
    whose traffic files a smaller pool: the cells' own code otherwise."""
    root = tmp_path_factory.mktemp("bench")
    shutil.copytree(PB, root / "perfbench", ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads(json.dumps(BENCH))
    for c in bench["configs"]:
        cfg = _small(c["name"])
        (root / c["file"]).write_text(json.dumps(cfg))
    for t in (root / "perfbench" / "traffic").glob("*.json"):
        spec = json.loads(t.read_text())
        spec.update(pool_batches=3, warmup_batches=2)
        t.write_text(json.dumps(spec))
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root


def _run(root, cell, trace=False, seconds=0.3, **kw):
    return core.run_cell(core.load_cell(cell, root), 2**31 + 3, seconds, trace,
                         device="cpu", **kw)


@pytest.mark.parametrize("cell", CELLS)
def test_small_cell_runs_correct(small_root, cell):
    r = _run(small_root, cell)
    assert list(r) == ["correct", "attempted", "failed", "metrics", "device", "setup", "checks"]
    assert r["correct"] and r["failed"] == 0 and r["attempted"] > 0
    want = [m["name"] for m in BENCH["end_to_end"] if cell in m.get("workloads", [cell])]
    assert sorted(r["metrics"]) == sorted(want)
    assert all(v["value"] > 0 for v in r["metrics"].values())
    cfg = core.load_cell(cell, small_root).config
    assert list(r["checks"]) == list(cfg["limits"]) + ["missing"]
    assert all(c["value"] <= c["limit"] for c in r["checks"].values())
    assert r["device"]["platform"] == "cpu"
    assert set(r["setup"]) == {"built", "start_s", "cuda_s", "inputs_s", "engine_s",
                               "warmup_s", "check_s"}


def test_small_traced_run_ends_with_checks(small_root):
    r = _run(small_root, "sift1m.online.b32.k10", trace=True)
    assert list(r)[-3:] == ["breakdown", "setup", "checks"] and r["correct"]
    assert r["device"]["window_s"] > 0 and r["device"]["busy_s"] == 0.0
    # no card: the device readers find nothing to read and say nothing
    assert not {"search_roofline", "device_idle_pct", "host_ms_per_call"} & set(r["metrics"])


def test_host_ms_per_call_reads_serial_calls_only():
    reader = core.load_module(ROOT, "metrics", "host_ms_per_call")
    win = core.Window(serial=True, taken=[0.0, 1.0], ready=[0.004, 1.006])
    tr = tracing.Trace(window_us=2e6, busy_us=3000.0, device_ops=[], idle_gaps=[])
    run = core.RunData(cell=None, setup_s=1.0, start=0.0, seconds=2.0, window=win,
                       roofline={}, trace=tr)
    assert reader.read(run) == pytest.approx((0.010 - 0.003) / 2 * 1e3)
    run.window.serial = False
    assert reader.read(run) is None


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("cell", ["sift1m.bulk.b256.k10", "msspacev10m.bulk.b128.k10",
                                  "sift1m.online.b32.k10", "sift1m.bulk.b128.k100"])
def test_planted_faults_come_out_not_correct(small_root, cell, fault):
    r = _run(small_root, cell, seconds=0.5, wrap=FAULTS[fault])
    assert not r["correct"] and r["failed"] > 0


@pytest.mark.parametrize("cell,precision", [
    ("sift1m.bulk.b256.k10", "tf32"), ("sift1m.online.b32.k10", "tf32"),
    ("sift1m.bulk.b128.k100", "tf32"), ("sift1m.bulk.b256.k10", "bf16"),
    ("msspacev10m.bulk.b128.k10", "int4")])
def test_lower_precision_control_comes_out_not_correct(small_root, cell, precision):
    c = core.load_cell(cell, small_root)
    [(_, ok, checks)] = control.readings(c, [9], 0.3, precision=precision, device="cpu")
    lim = c.config["limits"]
    assert not ok and any(checks[n] > lim[n] for n in lim)


def test_bf16_is_exact_on_int8_data(small_root):
    """Why int8 data's control is int4: int8 values are exact in bf16, and
    so are their products and sums in float64."""
    c = core.load_cell("msspacev10m.bulk.b128.k10", small_root)
    [(_, ok, checks)] = control.readings(c, [9], 0.3, precision="bf16", device="cpu")
    assert ok and checks["wrong_ids"] == 0 and checks["dist_gap"] == 0.0


def _digest(root):
    return {p.relative_to(root): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted((root / "perfbench").rglob("*")) if p.is_file()
            and "__pycache__" not in p.parts}


def test_new_cell_takes_new_files_only(small_root, tmp_path):
    root = tmp_path / "repo"
    shutil.copytree(small_root, root, ignore=shutil.ignore_patterns("__pycache__"))
    before = _digest(root)
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cfg = _small("sift1m", rows=2000)
    cfg.update(name="sift2k", dtype="float32")
    (root / "perfbench" / "configs" / "sift2k.json").write_text(json.dumps(cfg))
    (root / "perfbench" / "traffic" / "online.b8.k5.json").write_text(json.dumps(
        {"loop": "online", "batch": 8, "k": 5, "clients": 1, "filter": None,
         "pool_batches": 2, "warmup_batches": 1}))
    (root / "perfbench" / "metrics" / "p99_ms.py").write_text(
        "import numpy as np\n\ndef read(run):\n"
        "    lat = run.latencies_s()\n"
        "    return float(np.percentile(lat, 99)) * 1e3 if lat.size else None\n")
    bench["configs"].append({"name": "sift2k", "source": "x", "file": "perfbench/configs/sift2k.json",
                             "reduced": ["rows"], "why": "x"})
    bench["workloads"].append({"name": "sift2k.online.b8.k5", "config": "sift2k",
                               "traffic": "online.b8.k5", "chips": 1, "why": "x"})
    bench["end_to_end"].append({"name": "p99_ms", "unit": "ms", "better": "lower",
                                "bound": 0.1, "source": "host_clock",
                                "workloads": ["sift2k.online.b8.k5"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    r = _run(root, "sift2k.online.b8.k5")
    assert r["correct"] and {"qps", "p95_ms", "setup_s", "p99_ms"} <= set(r["metrics"])
    after = _digest(root)
    assert {p: h for p, h in after.items() if p in before} == before


# -- the trace's reduction ---------------------------------------------------


def test_trace_reduction():
    ev = [
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaMemcpyAsync", "ts": 52, "dur": 6, "tid": 1},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": 18, "dur": 1, "tid": 1},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaFree", "ts": 1, "dur": 1, "tid": 1},
        {"ph": "X", "cat": "cuda_runtime", "name": "other thread", "ts": 50, "dur": 30, "tid": 2},
        {"ph": "X", "cat": "kernel", "name": "k1", "ts": 20, "dur": 15, "tid": 7},
        {"ph": "X", "cat": "kernel", "name": "k1", "ts": 30, "dur": 10, "tid": 8},
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy DtoH", "ts": 70, "dur": 5, "tid": 7},
        {"ph": "X", "cat": "kernel", "name": "late", "ts": 95, "dur": 20, "tid": 7},
    ]
    # the window on the host clock: 120 us; the device's events 20-115
    tr = tracing.reduce(ev, 120.0)
    assert tr.window_us == 120 and tr.busy_us == 20 + 5 + 20
    assert dict(tr.device_ops) == {"k1": 25, "Memcpy DtoH": 5, "late": 20}
    # gaps 40-70 and 75-95, put down to what the main thread ran at their
    # middles, and the window's 25 us outside the device's events
    assert dict(tr.idle_gaps) == {tracing.IDLE_NO_HOST_EVENT: 20, "cudaMemcpyAsync": 30,
                                  tracing.IDLE_OUTSIDE: 25}
    assert tr.breakdown()["device_ops"][0] == ["k1", pytest.approx(25e-6)]
    assert tracing.reduce([], 5.0).busy_us == 0.0


# -- the command, and what a run loads ---------------------------------------


def test_run_without_card_fails_cleanly():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    p = subprocess.run([sys.executable, "perfbench/run.py", "--workload", CELLS[0],
                        "--seed", "1", "--seconds", "1", "--trace", "0"],
                       cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert p.returncode != 0 and "CUDA card" in p.stderr
    assert not any(line.startswith("{") for line in p.stdout.splitlines())


def test_run_refuses_an_unknown_workload():
    p = subprocess.run([sys.executable, "perfbench/run.py", "--workload", "no.such",
                        "--seed", "1", "--seconds", "1", "--trace", "0"],
                       cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert p.returncode != 0 and not p.stdout.strip()


def _loaded_after(code, root):
    p = subprocess.run([sys.executable, "-c", code], cwd=root, capture_output=True,
                       text=True, timeout=600, env=dict(os.environ, PYTHONPATH=str(ROOT)))
    assert p.returncode == 0, p.stderr[-3000:]
    return set(json.loads(p.stdout.strip().splitlines()[-1]))


def test_a_run_loads_no_jax_and_no_jax_package(small_root):
    code = (
        "import json, sys\n"
        "from perfbench import core, control, tracing\n"
        f"root = {str(small_root)!r}\n"
        "for kind in ('gen', 'program', 'loops', 'reference', 'roofline', 'metrics'):\n"
        "    import pathlib\n"
        "    for p in sorted(pathlib.Path(root, 'perfbench', kind).glob('*.py')):\n"
        "        core.load_module(root, kind, p.stem)\n"
        "cell = core.load_cell('msspacev10m.bulk.b128.k10', root)\n"
        "core.run_cell(cell, 4, 0.2, True, device='cpu')\n"
        "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))\n")
    top = _loaded_after(code, ROOT)
    assert not top & {"jax", "jaxlib", "flax", "metrovector_tpu"}
    assert "metrovector_tpu_torch" in top


def test_the_reference_loads_nothing_of_the_program(small_root):
    code = (
        "import json, sys, numpy as np, torch\n"
        "from perfbench import core\n"
        f"root = {str(small_root)!r}\n"
        "cell = core.load_cell('sift1m.bulk.b256.k10', root)\n"
        "gen = core.load_module(root, 'gen', cell.config['generator'])\n"
        "ref = core.load_module(root, 'reference', cell.config['reference'])\n"
        "rows, q = gen.make(cell.config, 3, torch.device('cpu'), 8, 3000, 128)\n"
        "ref.answers(cell.config, rows, [q], 10)\n"
        "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))\n")
    top = _loaded_after(code, ROOT)
    assert not top & {"jax", "jaxlib", "flax", "metrovector_tpu", "metrovector_tpu_torch"}


def test_forbidden_modules_compares_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "metrovector_tpu_torch_extra", object())
    assert "metrovector_tpu" not in core.forbidden_modules()
    monkeypatch.setitem(sys.modules, "jaxlib.fake", object())
    assert "jaxlib" in core.forbidden_modules()


# -- on the card ------------------------------------------------------------


@pytest.mark.cuda
def test_short_run_of_each_cell_on_the_card(card):
    for cell in CELLS:
        p = subprocess.run([sys.executable, "perfbench/run.py", "--workload", cell,
                            "--seed", "77", "--seconds", "2", "--trace", "0"],
                           cwd=ROOT, capture_output=True, text=True, timeout=1500)
        assert p.returncode == 0, p.stderr[-3000:]
        r = json.loads(p.stdout.strip().splitlines()[-1])
        assert r["correct"] and r["device"]["platform"] == "gpu", r
