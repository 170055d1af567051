"""The control-plane copies the router leans on — the port's
``admission``, ``health``, ``sessions``, ``critpath``, ``ledger``,
``loadgen`` and ``utils/{tracing,trace_stitch,metrics}`` — held to the
reference's own cases.

The cases of ``tests/test_{admission,slo,sessions,critpath,health}.py``
that need no JAX engine (and no ``top``/``doctor``, which the port does
not carry) run here unchanged against the port: each reference test file
is compiled with its ``infinistore_tpu`` imports pointed at
``infinistore_tpu_torch``, and the chosen cases are collected from it under
``test_<file>__<case>``.  So a case's assertions, inputs and stubs are the
reference's, character for character, and only the modules under test
differ.
"""

import pathlib
import re
import types

HERE = pathlib.Path(__file__).parent

# (reference test file, its cases that need no JAX engine)
CASES = {
    "test_admission.py": [
        "test_parse_quotas_formats",
        "test_retry_after_header_is_integer_seconds",
        "test_quota_refill_math_and_debt",
        "test_quota_burst_cap_and_multi_tenant_isolation",
        "test_quota_retry_after_is_own_refill_time_clamped",
        "test_decision_table_burn_sheds_lowest_lane_first",
        "test_decision_table_burn_requires_page_severity_and_burn_rule",
        "test_decision_table_single_lane_duty_cycles",
        "test_decision_table_pool_pressure_sheds_non_protected",
        "test_decision_table_quota_throttles_before_global_shed",
        "test_retry_after_bounds_and_drain_scaling",
        "test_prefill_budget_degraded_mode",
        "test_kill_switch_and_snapshot_shape",
        "test_summarize_counts_rejected_separately",
    ],
    "test_slo.py": [
        "test_arrival_offsets_math",
        "test_open_loop_pacer_with_injected_clock",
        "test_make_requests_population",
        "test_summarize_per_lane_percentiles",
        "test_build_record_waterfall_sums_to_e2e",
        "test_ledger_ring_overflow_and_limit",
        "test_ledger_log_line_carries_request_trace_id",
    ],
    "test_sessions.py": [
        "test_session_ledger_waste_math_warm_vs_cold",
        "test_session_ledger_sessionless_requests_are_ignored",
        "test_session_ledger_lru_bound_and_exact_totals",
        "test_session_ledger_snapshot_shape_limit_and_active_window",
        "test_session_ledger_metric_families",
        "test_reprefill_waste_watchdog_rule",
        "test_make_sessions_deterministic_with_shared_system_prompt",
        "test_run_sessions_prefix_growth_and_summary",
        "test_session_summary_flat_vs_growing_and_tombstones",
    ],
    "test_critpath.py": [
        "test_decompose_stages_sum_to_admission_plus_e2e",
        "test_decompose_reports_unclaimed_wall_clock_explicitly",
        "test_merge_mesh_rows_remaps_roles_and_names_remainder",
        "test_aggregate_shape_dominant_and_worst",
        "test_stage_ledger_fold_annotate_and_snapshot",
        "test_stage_budget_rule_fires_on_breach_and_names_the_stage",
        "test_stage_budget_env_forms",
        "test_ring_drop_counter_is_race_exact",
        "test_gather_remote_counts_every_outcome",
    ],
    "test_health.py": [
        "test_ring_rollup_tiers_aggregate_correctly",
        "test_ring_overflow_is_fixed_memory",
        "test_windowed_reads_fall_back_to_rollup_tiers",
        "test_changes_and_slope",
        "test_burn_rate_requires_both_windows",
        "test_burn_rate_threshold_and_budget_math",
        "test_circuit_rule_open_and_flap",
        "test_sampler_fire_clear_transitions_and_metrics",
        "test_clear_hysteresis_holds_until_clear_for_s",
        "test_snapshot_series_limit_and_kill_switch",
        "test_env_knobs",
    ],
}

# the control-plane modules under test: an import of one of them from
# ``infinistore_tpu`` is pointed at the port's copy; every other import
# (the reference's engine, models and server, which some files set up at
# module level for their live cases) is left as it is
_PORTED = r"(?:admission|health|sessions|critpath|ledger|loadgen|usage" \
          r"|utils|engine\.scheduler)"
_IMPORT = re.compile(
    r"^(\s*from\s+)infinistore_tpu(\.%s\b)" % _PORTED, re.M)
_IMPORT_FROM_PKG = re.compile(
    r"^(\s*from\s+)infinistore_tpu(\s+import\s+%s\b)" % _PORTED, re.M)


def _port_source(filename: str):
    """The reference test file's source with its control-plane imports
    pointed at the port, and how many imports were rewritten."""
    src, n1 = _IMPORT.subn(r"\1infinistore_tpu_torch\2",
                           (HERE / filename).read_text())
    src, n2 = _IMPORT_FROM_PKG.subn(r"\1infinistore_tpu_torch\2", src)
    return src, n1 + n2


def _against_the_port(filename: str) -> types.ModuleType:
    path = HERE / filename
    mod = types.ModuleType(f"port_{path.stem}")
    mod.__file__ = str(path)
    exec(compile(_port_source(filename)[0], str(path), "exec"), mod.__dict__)
    return mod


def _collect():
    found = {}
    for filename, names in CASES.items():
        mod = _against_the_port(filename)
        for name in names:
            found[f"test_{pathlib.Path(filename).stem[5:]}__{name[5:]}"] = \
                getattr(mod, name)
    return found


globals().update(_collect())


def test_cases_run_against_the_ports_modules():
    """Every chosen case exists in its reference file, and every import of
    a control-plane module in that file now names the port's copy."""
    for filename, names in CASES.items():
        src, n = _port_source(filename)
        assert n > 0, filename
        assert not _IMPORT.search(src) and not _IMPORT_FROM_PKG.search(src)
        mod = _against_the_port(filename)
        assert all(callable(getattr(mod, name)) for name in names), filename
