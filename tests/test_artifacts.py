"""Benchmark artifact writer (reference Performance.csv/png layout)."""

import csv
import os

import pytest

from vit_tpu.bench.artifacts import selftest, write_perf_report


def test_write_perf_report(tmp_path):
    rows = [{"N": 256, "cudnn_ms": 1.0, "xla_ms": 2.0},
            {"N": 512, "cudnn_ms": 2.0, "xla_ms": 4.0}]
    out = write_perf_report("unit", rows, x_key="N",
                            y_keys=["cudnn_ms", "xla_ms"],
                            out_root=str(tmp_path))
    with open(os.path.join(out, "Performance.csv")) as f:
        got = list(csv.DictReader(f))
    assert got[0]["N"] == "256" and got[1]["xla_ms"] == "4.0"
    assert os.path.exists(os.path.join(out, "Performance.png"))


def test_selftest_passes_and_fails(capsys):
    selftest("ok", [1.0, 2.0], [1.0, 2.0], atol=1e-6)
    assert "PASSED" in capsys.readouterr().out
    with pytest.raises(AssertionError):
        selftest("bad", [1.0, 2.0], [1.0, 3.0], atol=1e-6)
    assert "FAILED" in capsys.readouterr().out


def test_published_csvs_are_sane(tmp_path, monkeypatch):
    # Round-1 lesson: a noise-dominated timing harness published negative
    # times (-97 TFLOP/s) — every artifact the model sweep writes must stay
    # positive, and so must every committed one.
    import glob

    from vit_tpu.bench import model as M

    times = iter([0.5, 3.0])
    monkeypatch.setattr(M, "bench_chained",
                        lambda step, reps, args: next(times))
    monkeypatch.setattr(M, "init_params", lambda k, cfg: {})
    rows = M.sweep(batches=[1, 32], reps=1)
    write_perf_report("model", rows, x_key="batch", y_keys=["ms"],
                      out_root=str(tmp_path), plot=False)
    paths = glob.glob(str(tmp_path / "**" / "*.csv"), recursive=True)
    paths += glob.glob("benchmarks/**/*.csv", recursive=True)
    assert paths, "no benchmark artifact written"
    for p in paths:
        with open(p) as f:
            rows = list(csv.DictReader(f))
        assert rows, p
        for row in rows:
            for k, v in row.items():
                try:
                    x = float(v)
                except (TypeError, ValueError):
                    continue
                assert x >= 0, (p, k, v)


def test_read_committed_roundtrip(tmp_path):
    """The drift-gate's committed-CSV reader parses batches as ints,
    numerics as floats, skips blanks, and returns {} for a missing file."""
    from vit_tpu.bench.model import read_committed

    rows = [{"batch": 1, "ms": 0.5, "img_per_s": 2000.0, "hf_gpu": 4.7},
            {"batch": 32, "ms": 8.0, "img_per_s": 4000.0}]
    write_perf_report("m", rows, x_key="batch", y_keys=["ms"],
                      out_root=str(tmp_path), plot=False)
    got = read_committed("m", out_root=str(tmp_path))
    assert set(got) == {1, 32}
    assert got[1]["ms"] == 0.5 and isinstance(got[1]["batch"], int)
    assert "hf_gpu" not in got[32]  # blank cell skipped, not ""
    assert read_committed("nope", out_root=str(tmp_path)) == {}


def test_sweep_drift_gate_and_carry_forward(tmp_path, monkeypatch):
    """>8% deviation from the committed row re-measures twice and
    publishes the median; main()'s merge carries forward committed rows
    the run did not re-measure (the round-4 bs=128-dropped-row lesson)."""
    from vit_tpu.bench import model as M

    committed = {1: {"batch": 1, "ms": 1.0},
                 64: {"batch": 64, "ms": 10.0}}
    times = iter([2.0, 1.4, 1.1])  # first noisy, then settling
    monkeypatch.setattr(M, "bench_chained",
                        lambda step, reps, args: next(times))
    monkeypatch.setattr(M, "init_params", lambda k, cfg: {})
    rows = M.sweep(batches=[1], reps=1, committed=committed)
    # median of [2.0, 1.4, 1.1] = 1.4
    assert rows[0]["ms"] == 1.4
    # carry-forward merge (main()'s logic, exercised directly):
    measured = {r["batch"] for r in rows}
    carried = [committed[b] for b in sorted(committed) if b not in measured]
    assert [r["batch"] for r in carried] == [64]


def test_serving_merge_rows(tmp_path, monkeypatch):
    """bench.serving row merge keys on (metric, quant, mesh) — a mesh run
    must not clobber the single-device trace row, and vice versa."""
    import vit_tpu.bench.serving as S

    monkeypatch.chdir(tmp_path)
    write_perf_report("serving", [
        {"metric": "mixed_trace", "quant": 0, "requests": 13,
         "img_per_s": 393.3}], x_key="requests", y_keys=["img_per_s"],
        out_root="benchmarks", plot=False)
    merged = S._merge_serving_rows("benchmarks", [
        {"metric": "mixed_trace_mesh", "quant": 0, "mesh": "4x2",
         "requests": 13, "img_per_s": 1000.0}])
    assert {r["metric"] for r in merged} == {"mixed_trace",
                                             "mixed_trace_mesh"}
    # replacing the same identity overwrites, not duplicates
    merged2 = S._merge_serving_rows("benchmarks", [
        {"metric": "mixed_trace", "quant": 0, "requests": 13,
         "img_per_s": 400.0}])
    assert len(merged2) == 1 and merged2[0]["img_per_s"] == 400.0


def test_write_perf_report_html(tmp_path):
    rows = [{"N": 256, "ms": 1.0}, {"N": 512, "ms": 2.0}]
    out = write_perf_report("unit_html", rows, x_key="N", y_keys=["ms"],
                            out_root=str(tmp_path))
    html = open(os.path.join(out, "results.html")).read()
    assert "<td>512</td>" in html and "<th>ms</th>" in html


def test_forward_tflops_counts_real_tokens():
    # 2*MAC over the 197 tokens the forward computes (no padding): B/16 at
    # bs=1 is ~35.2 GFLOP (12 layers x 2.92 + the 0.23 patch projection).
    from vit_tpu.bench.model import forward_tflops
    from vit_tpu.config import ViTConfig

    cfg = ViTConfig()
    s, d, m = 197, 768, 3072
    layer = 8 * s * d * d + 4 * s * s * d + 4 * s * d * m
    want = (12 * layer + 2 * 196 * 768 * d) / 1e12
    assert forward_tflops(cfg, 1) == pytest.approx(want)
    assert forward_tflops(cfg, 32) == pytest.approx(32 * want)
