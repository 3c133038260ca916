"""The benchmark harness's own tests (``perfbench/tests/test_perfbench_harness.py``)
collected under ``tests/``, so that they run with the rest of the suite:
its files against the contract, the generators, the rooflines' worked
bounds, the reference against a NumPy brute force, a traced run, the
int4 control, the trace's reduction, the refusal without a card and what a
run loads. Their tables of small sizes and worked roofline bounds gain the
``gist1m`` configuration and its cell, which ``BENCHMARK.json`` lists
beside the first four.

Left out here, and run by ``python -m pytest perfbench/tests``: the tests
that need a call answered inside a 0.3-s window, which a host loaded by the
suite's other workers may not give (``tests/test_gist1m_cell.py`` holds the
gist1m cell to the same checks by a count of calls), and the one that
needs a process without JAX, which ``tests/conftest.py`` imports."""

from perfbench.tests import test_perfbench_harness as harness

# 3,000 rows of 960 at 12 centres, as many rows to a centre as the cell's
harness.SMALL_ROWS.setdefault("gist1m", 3000)
# 6·b·n·d at 989 TFLOP/s; 3,845,019,904 B (f32 rows, norms, queries, 18
# fetched a query) at 3.35 TB/s
harness.WORKED_MS.setdefault("gist1m.bulk.b256.k10.high_verified",
                             (1.490961, 1.147767, "ops"))

from perfbench.tests.test_perfbench_harness import (  # noqa: E402,F401
    small_root,
    test_a_run_loads_no_jax_and_no_jax_package,
    test_benchmark_json_keys_names_and_units,
    test_bf16_is_exact_on_int8_data,
    test_config_files_name_their_parts,
    test_generators_repeat_by_seed,
    test_host_ms_per_call_reads_serial_calls_only,
    test_reference_judges_served_rows_by_their_exact_distance,
    test_reference_matches_numpy_brute_force_with_ties,
    test_roofline_worked_bounds,
    test_run_refuses_an_unknown_workload,
    test_run_without_card_fails_cleanly,
    test_small_traced_run_ends_with_checks,
    test_the_reference_loads_nothing_of_the_program,
    test_trace_reduction,
    test_traffic_files_parse,
)
