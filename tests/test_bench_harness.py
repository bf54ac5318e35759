"""The bench harness contract: the record must survive truncation.

The driver captures only the last ~2000 characters of stdout and parses
a JSON line from them (rounds 3 and 4 both lost their perf records to
this).  These tests pin the harness invariants without touching a
device: compact projections stay small, the merged line stays under the
tail cap even with every section populated, and the emergency slim-down
path keeps the required metric fields.
"""

import json

import bench


# made-up values with the width of real ones (the line-length checks
# below depend on how many digits each field prints)
FULL_SECTIONS = {
    "e2e": {
        "fps_warm": 12.34, "fps_cold": 5.67, "rotation_rmse_deg": 0.1234,
        "rotation_rmse_deg_noloop": 1.2345, "loop_gain": 9.87,
        "loop_edges": 65, "vocab_words": 100000,
    },
    "incremental": {
        "fps": 4.32, "fps_steady": 21.09, "rotation_rmse_deg": 0.5432,
        "loop_edges": 7, "rotavg_ms_p50": 3.2, "vocab_words": 100000,
    },
    "windows": {
        "windows_per_s": 9876.5, "vs_oracle": 43.2,
        "mean_err_vs_gt_deg": 1.234, "chol_knee_W": 24576,
        "chol_knee_solves_per_s": 987654.0,
    },
    "vocab": {
        "production_scale": {"n_words": 10 ** 6, "text_mb": 123.4,
                             "native_parse_s": 0.98},
        "transform_desc_per_s": 876543.0, "cascade_query_ms": 4.32,
    },
    "large": {
        "n_views": 50000, "solve_s": 10.987, "converged": True,
        "mean_err_vs_gt_deg": 2.345,
    },
    "scaling": {
        "by_size": {
            "20k": {"by_devices": {"8": {"work_conservation": 0.876}}},
            "50k": {"by_devices": {"8": {"work_conservation": 0.765}}},
        },
    },
}


def test_compact_projections_cover_every_section():
    for name, full in FULL_SECTIONS.items():
        comp = bench._compact_of(name, full)
        assert comp, f"empty compact projection for {name}"
        # compact values must be scalars (JSON-small), not nested blobs
        for v in comp.values():
            assert not isinstance(v, (dict, list)), (name, v)


def test_compact_projections_pass_through_errors():
    assert bench._compact_of("e2e", {"error": "X"}) == {"error": "X"}
    assert bench._compact_of("large", {"skipped": "budget"}) == {
        "skipped": "budget"}


def test_merged_line_fits_the_driver_tail_cap():
    compact = {
        "metric": "batch_ravg_solve_ms_m3655_n1832", "unit": "ms",
        "platform": "gpu", "budget_s": 900.0, "detail": "BENCH_FULL.json",
        "skipped": [], "value": 12.34, "vs_baseline": 5.678,
        "quality_ok": True, "elapsed_s": 654.3,
        "sections": {n: bench._compact_of(n, f)
                     for n, f in FULL_SECTIONS.items()},
    }
    line = json.dumps(compact, separators=(",", ":"))
    assert len(line) < 1800, len(line)
    # and it round-trips with the required metric fields present
    parsed = json.loads(line)
    for key in ("metric", "value", "unit", "vs_baseline"):
        assert key in parsed


def test_emit_slims_oversized_lines(tmp_path, capsys, monkeypatch):
    monkeypatch.setattr(bench, "FULL_PATH", str(tmp_path / "full.json"))
    monkeypatch.setitem(bench._COMPACT, "metric", "m")
    monkeypatch.setitem(bench._COMPACT, "value", 1.0)
    monkeypatch.setitem(bench._COMPACT, "unit", "ms")
    monkeypatch.setitem(bench._COMPACT, "vs_baseline", 2.0)
    # oversized junk that must be slimmed away
    monkeypatch.setitem(bench._COMPACT, "sections", {"x": "y" * 4000})
    bench._FULL["sections"] = {"x": "big"}
    bench._emit()
    out = capsys.readouterr().out.strip().splitlines()[-1]
    assert len(out) < 2000
    parsed = json.loads(out)
    for key in ("metric", "value", "unit", "vs_baseline"):
        assert key in parsed
    # the full-detail file was still written
    assert (tmp_path / "full.json").exists()
    bench._COMPACT.pop("sections", None)
    bench._FULL.pop("sections", None)
