"""The port's bench-trend gate (``vlog_tpu_torch/obs/benchtrend.py``)
against the JAX package's, on the committed BENCH_*.json/MULTICHIP*.json
files and on synthetic trajectories.

Each case hands one root to both gates and requires the same report, the
same CLI output (plain, ``--json``, ``--check``) and the same exit codes.
The reference's own benchtrend tests (``tests/test_perf_observatory.py``)
then run once more with the port's module in place of the reference's.
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

import tests.test_perf_observatory as ref_tests
from vlog_tpu import config as jconfig
from vlog_tpu.obs import benchtrend as jbt
from vlog_tpu_torch import config as tconfig
from vlog_tpu_torch.obs import benchtrend as tbt

ROOT = Path(__file__).resolve().parents[1]


def _cli(mod, argv, capsys) -> tuple[int, str]:
    rc = mod.main(argv)
    return rc, capsys.readouterr().out


def _assert_alike(root, capsys) -> dict:
    """Both gates over ``root``: equal reports, CLI output and codes."""
    want = jbt.trend_report(root)
    got = tbt.trend_report(root)
    assert got == want
    for argv in ([], ["--json"], ["--check"], ["--check", "--json"]):
        argv = [*argv, "--root", str(root)]
        assert _cli(tbt, argv, capsys) == _cli(jbt, argv, capsys)
    assert tbt.summary_line(root) == jbt.summary_line(root)
    return got


def test_committed_files_same_trajectory_and_verdict(capsys):
    rep = _assert_alike(ROOT, capsys)
    assert rep["ok"], rep["regressions"]
    assert rep["series"] >= 20 and rep["gated_points"] >= 40
    files = tbt.bench_files(ROOT)
    assert [p.name for p in files] == [p.name for p in jbt.bench_files(ROOT)]
    for f in files:
        assert [vars(p) for p in tbt.parse_file(f, f.name)] == \
            [vars(p) for p in jbt.parse_file(f, f.name)]


def test_default_root_is_the_repo(capsys):
    assert tbt.trend_report()["root"] == str(ROOT)
    assert _cli(tbt, ["--check"], capsys)[0] == 0


def _seed(tmp_path: Path) -> Path:
    root = tmp_path / "traj"
    root.mkdir()
    for f in jbt.bench_files(ROOT):
        shutil.copy(f, root / f.name)
    return root


def test_synthetic_regression_same_verdict(tmp_path, capsys):
    root = _seed(tmp_path)
    path = root / "BENCH_coord.json"
    data = json.loads(path.read_text())
    tmpl = dict(next(r for r in data if r.get("step") == "poll_only"
                     and r.get("metric") == "coord_claims_per_s"))
    tmpl["rps"] = 1.0
    tmpl["timestamp"] = "2099-01-01T00:00:00Z"
    data.append(tmpl)
    path.write_text(json.dumps(data))
    rep = _assert_alike(root, capsys)
    assert not rep["ok"]
    assert any(r["metric"] == "coord_claims_per_s"
               for r in rep["regressions"])
    assert tbt.main(["--check", "--root", str(root)]) == 1
    capsys.readouterr()


def _write(root: Path, name: str, recs) -> None:
    root.mkdir(exist_ok=True)
    (root / name).write_text(json.dumps(recs))


@pytest.mark.parametrize("case", ["tpu_only_cpu", "fallback", "tpu_only_tpu",
                                  "lower_floor", "lower_cliff", "wrapper"])
def test_synthetic_fixtures_same_output(case, tmp_path, capsys):
    root = tmp_path / case
    base = {"metric": "fix_device_realtime_x", "value": 100.0,
            "gate": "tpu_only", "timestamp": "2026-01-01T00:00:00Z"}
    crater = {"metric": "fix_device_realtime_x", "value": 1.0,
              "gate": "tpu_only", "timestamp": "2026-02-01T00:00:00Z"}
    if case == "tpu_only_cpu":
        _write(root, "BENCH_fix.json", [base, {**crater, "platform": "cpu"}])
        ok = True
    elif case == "fallback":
        _write(root, "BENCH_fix.json", [base, {
            **crater, "fallback_reason": "tunnel_dead_probe_timeout"}, {
            "metric": "fix_device_realtime_x_cpu_fallback", "value": 1.0,
            "timestamp": "2026-03-01T00:00:00Z"}, {
            "metric": "fix_device_realtime_x", "value": 1.0,
            "unit": "bench_failed_all_platforms",
            "timestamp": "2026-04-01T00:00:00Z"}])
        ok = True
    elif case == "tpu_only_tpu":
        _write(root, "BENCH_fix.json", [base, crater])
        ok = False
    elif case == "lower_floor":
        _write(root, "BENCH_fix.json", [
            {"metric": "fix_wait_p99_s", "value": 0.0015,
             "timestamp": "2026-01-01T00:00:00Z"},
            {"metric": "fix_wait_p99_s", "value": 0.0031,
             "timestamp": "2026-02-01T00:00:00Z"}])
        ok = True
    elif case == "lower_cliff":
        _write(root, "BENCH_fix.json", [
            {"metric": "fix_wait_p99_s", "value": 0.2,
             "timestamp": "2026-01-01T00:00:00Z"},
            {"metric": "fix_wait_p99_s", "value": 2.0,
             "timestamp": "2026-02-01T00:00:00Z"}])
        ok = False
    else:
        root.mkdir()
        (root / "BENCH_r99.json").write_text(json.dumps({
            "n": 99, "rc": 0, "parsed": {"metric": "fix_tail_x",
                                         "value": 7.0},
            "tail": "noise\n" + json.dumps(
                {"metric": "fix_tail_x", "value": 7.0}) + "\n"
            + json.dumps({"metric": "fix_tail_x", "value": 2.0}) + "\n"}))
        _write(root, "BENCH_legacy.json", [
            {"metric": "segment_delivery", "hot_cache_rps": 1000.0,
             "cold_origin_rps": 100.0, "speedup_x": 10.0}])
        _write(root, "MULTICHIP_r99.json", [{"metric": "fix_mc", "fps": 3}])
        ok = False
    rep = _assert_alike(root, capsys)
    assert rep["ok"] is ok, rep["regressions"]


@pytest.mark.parametrize("tol", [0.01, 0.9])
def test_tolerance_knob_same_verdict(tol, tmp_path, monkeypatch, capsys):
    root = tmp_path / "tol"
    _write(root, "BENCH_fix.json", [
        {"metric": "fix_fps", "value": 100.0,
         "timestamp": "2026-01-01T00:00:00Z"},
        {"metric": "fix_fps", "value": 60.0,
         "timestamp": "2026-02-01T00:00:00Z"}])
    monkeypatch.setattr(jconfig, "BENCHTREND_TOL", tol)
    monkeypatch.setattr(tconfig, "BENCHTREND_TOL", tol)
    rep = _assert_alike(root, capsys)
    assert rep["tolerance_default"] == tol
    assert rep["ok"] is (tol > 0.4)


def test_tolerance_env_knob_parsed_alike(tmp_path):
    """``VLOG_BENCHTREND_TOL`` at import, both packages, in a child each:
    the same report at 0.1, the same refusal under the floor
    (``lo=0.01``)."""
    root = tmp_path / "env"
    _write(root, "BENCH_fix.json", [
        {"metric": "fix_fps", "value": 100.0,
         "timestamp": "2026-01-01T00:00:00Z"},
        {"metric": "fix_fps", "value": 80.0,
         "timestamp": "2026-02-01T00:00:00Z"}])
    outs = {}
    for pkg in ("vlog_tpu", "vlog_tpu_torch"):
        for tol in ("0.1", "0.001"):
            env = {**os.environ, "VLOG_BENCHTREND_TOL": tol,
                   "JAX_PLATFORMS": "cpu", "PYTHONPATH": str(ROOT)}
            proc = subprocess.run(
                [sys.executable, "-m", f"{pkg}.obs.benchtrend", "--json",
                 "--check", "--root", str(root)],
                capture_output=True, text=True, env=env, cwd=ROOT,
                timeout=300)
            last = (proc.stderr.strip().splitlines() or [""])[-1]
            outs[(pkg, tol)] = (proc.returncode, proc.stdout,
                                last.split(".config.", 1)[-1])
    for tol in ("0.1", "0.001"):
        assert outs[("vlog_tpu_torch", tol)] == outs[("vlog_tpu", tol)]
    rc, out, _ = outs[("vlog_tpu_torch", "0.1")]
    rep = json.loads(out)
    assert rc == 1 and rep["tolerance_default"] == 0.1 and not rep["ok"]
    rc, out, err = outs[("vlog_tpu_torch", "0.001")]
    assert rc != 0 and out == ""
    assert err == ("ConfigError: VLOG_BENCHTREND_TOL=0.001 below minimum "
                   "0.01")


@pytest.mark.parametrize("method", [
    "test_round_trips_every_committed_file", "test_head_is_green",
    "test_check_exit_codes", "test_tpu_only_and_fallback_records_never_gate",
    "test_lower_is_better_and_abs_floor", "test_wrapper_and_legacy_shapes"])
def test_reference_benchtrend_cases_hold_for_the_port(method, tmp_path,
                                                      monkeypatch):
    monkeypatch.setattr(ref_tests, "bt", tbt)
    case = ref_tests.TestBenchtrend()
    fn = getattr(case, method)
    if fn.__code__.co_argcount > 1:
        fn(tmp_path)
    else:
        fn()
