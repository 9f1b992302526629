"""Bench-trend regression gate over the committed BENCH/MULTICHIP files
(port of ``vlog_tpu/obs/benchtrend.py``: same parser, series, gating
rules and output, so both gates give one verdict on one trajectory).

Every perf PR appends labeled records to the repo's append-only
trajectories (BENCH_*.json, MULTICHIP*.json); nothing ever re-reads
them, so a regression only surfaces if a human rereads JSON. This
module parses every committed file into one unified trajectory keyed by
``(metric, step, identity-config)``, then flags any series whose latest
gated point fell beyond tolerance below the best prior point (or rose
above it, for lower-is-better metrics).

File shapes handled (all present in the committed files and
round-tripped by tests/test_torch_benchtrend.py, so schema drift breaks
the tier-1 lane, not the gate):

- labeled record lists (``[{metric, value|rps|fps|..., step?, config?,
  gate?, platform?}, ...]``) — BENCH_asr/compile/coord/delivery.json,
  MULTICHIP.json;
- one legacy unlabeled first record in BENCH_delivery.json
  ({metric, hot_cache_rps, cold_origin_rps, ...});
- runner wrappers (``{n, cmd, rc, tail, parsed?}`` /
  ``{n_devices, rc, ok, skipped, tail}``) — BENCH_r0N.json,
  MULTICHIP_r0N.json — whose ``parsed`` record and any JSON lines
  embedded in ``tail`` are recovered.

Gating rules:

- records labeled ``gate: tpu_only`` count only when produced on a TPU
  (``platform`` absent or "tpu"); CPU-fallback records (explicit
  ``fallback_reason``, a ``*_cpu_fallback`` metric name, or the
  bench-failed sentinel unit) chart but never gate;
- direction comes from an explicit per-metric table plus name
  heuristics (``*_p99_s``/``*_wait_s``/``*pad_waste*``/``warm_ratio``
  are lower-is-better);
- tolerance is ``VLOG_BENCHTREND_TOL`` (relative, default 0.5 — these
  series mix machines and VM generations, so only large cliffs gate)
  with per-metric overrides, and latencies additionally get an absolute
  floor so microsecond jitter on a sub-ms p99 cannot fail CI.

CLI: ``python -m vlog_tpu_torch.obs.benchtrend [--check] [--root DIR]
[--json]`` — ``--check`` exits 1 on any regression (the tier-1
agreement test runs exactly this over the committed files);
:func:`summary_line` is the one-line stamp a bench record carries.
"""

from __future__ import annotations

import json
import math
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Iterable

from vlog_tpu_torch import config

# metric names where smaller is better; everything else defaults to
# larger-is-better unless a name heuristic (below) says otherwise
_LOWER_IS_BETTER = {
    "compile_cache_warm_ratio",
    "enqueue_to_claim_p99_s",
}
_LOWER_SUFFIXES = ("_p99_s", "_p95_s", "_p50_s", "_wait_s", "_latency_s",
                   "_seconds")
_LOWER_SUBSTRINGS = ("pad_waste", "warm_ratio")

# per-metric relative tolerance overrides (fraction of the best prior
# value the latest may fall short by before gating). The default,
# config.BENCHTREND_TOL, is deliberately loose: the committed series
# span different machines, VM generations, and contended CI hosts.
_TOL_OVERRIDES = {
    # soak numbers swing ~2x run-to-run with cache temperature
    "fabric_soak_rps": 0.75,
    "ram_hit_rps": 0.6,
}

# lower-is-better latencies additionally need an absolute floor: the
# committed enqueue_to_claim_p99_s series is 1.5ms vs 3.1ms — a 2.07x
# "regression" that is pure scheduler jitter. Below the floor, absolute
# values gate instead of ratios.
_ABS_FLOOR_S = 0.05

# config keys that distinguish otherwise same-named series (a batched
# claim at max_jobs=16 is not comparable to max_jobs=8)
_IDENTITY_KEYS = ("max_jobs", "workload", "mesh_shape", "db", "quant",
                  "platform", "devices")
_IDENTITY_TOP_KEYS = ("killed_origin", "platform")

_VALUE_KEYS = ("value", "rps", "fps", "win_x", "speedup_x",
               "realtime_x", "ratio")

_FALLBACK_UNIT = "bench_failed_all_platforms"


@dataclass
class Point:
    """One labeled bench record flattened into the trajectory."""

    file: str
    index: int                      # position within the file
    metric: str
    value: float
    step: str = ""
    unit: str = ""
    timestamp: float = 0.0
    gate: str = ""                  # "" or "tpu_only"
    platform: str = ""              # "" (assume native), "cpu", "tpu"
    fallback: bool = False
    config: dict = field(default_factory=dict)
    raw: dict = field(default_factory=dict)

    @property
    def series_key(self) -> str:
        ident = []
        for k in _IDENTITY_KEYS:
            v = self.config.get(k)
            if v is not None:
                ident.append(f"{k}={v}")
        for k in _IDENTITY_TOP_KEYS:
            v = self.raw.get(k)
            if v is not None:
                ident.append(f"{k}={v}")
        base = f"{self.metric}|{self.step}" if self.step else self.metric
        return f"{base}|{','.join(ident)}" if ident else base

    @property
    def gated(self) -> bool:
        """Does this point participate in regression gating?"""
        if self.fallback:
            return False
        if self.gate == "tpu_only" and self.platform == "cpu":
            return False
        return True


def _is_lower_better(metric: str) -> bool:
    if metric in _LOWER_IS_BETTER:
        return True
    if any(metric.endswith(s) for s in _LOWER_SUFFIXES):
        return True
    return any(s in metric for s in _LOWER_SUBSTRINGS)


def _tolerance(metric: str) -> float:
    return _TOL_OVERRIDES.get(metric, config.BENCHTREND_TOL)


def _record_value(rec: dict) -> float | None:
    for k in _VALUE_KEYS:
        v = rec.get(k)
        if isinstance(v, (int, float)) and not isinstance(v, bool) \
                and math.isfinite(float(v)):
            return float(v)
    return None


def _ts(v: Any) -> float:
    """Epoch seconds from a numeric or ISO-8601 timestamp (the
    committed files use ``2026-08-05T03:32:25Z`` strings); 0.0 when
    absent or unparseable (append order then decides)."""
    if isinstance(v, (int, float)) and not isinstance(v, bool):
        return float(v)
    if isinstance(v, str) and v:
        from datetime import datetime

        try:
            return datetime.fromisoformat(v.replace("Z", "+00:00")) \
                .timestamp()
        except ValueError:
            return 0.0
    return 0.0


def _is_fallback(rec: dict) -> bool:
    if rec.get("fallback_reason"):
        return True
    if "cpu_fallback" in str(rec.get("metric", "")):
        return True
    return rec.get("unit") == _FALLBACK_UNIT


def _point_from_record(rec: dict, file: str, index: int) -> Point | None:
    metric = rec.get("metric")
    if not isinstance(metric, str) or not metric:
        return None
    value = _record_value(rec)
    if value is None:
        return None
    cfg = rec.get("config") if isinstance(rec.get("config"), dict) else {}
    return Point(
        file=file, index=index, metric=metric, value=value,
        step=str(rec.get("step", "") or ""),
        unit=str(rec.get("unit", "") or ""),
        timestamp=_ts(rec.get("timestamp")),
        gate=str(rec.get("gate", "") or ""),
        platform=str(rec.get("platform", "")
                     or cfg.get("platform", "") or ""),
        fallback=_is_fallback(rec),
        config=cfg, raw=rec)


def _tail_records(tail: Any) -> Iterable[dict]:
    """Recover labeled JSON-line records embedded in a runner wrapper's
    captured ``tail`` text (BENCH_r02.json carries its result only
    there)."""
    if isinstance(tail, list):
        lines: Iterable[str] = [str(x) for x in tail]
    elif isinstance(tail, str):
        lines = tail.splitlines()
    else:
        return
    for line in lines:
        line = line.strip()
        if not (line.startswith("{") and '"metric"' in line):
            continue
        try:
            rec = json.loads(line)
        except ValueError:
            continue
        if isinstance(rec, dict):
            yield rec


def parse_file(path: Path, rel: str | None = None) -> list[Point]:
    """Every labeled point recoverable from one committed bench file.
    Unparseable files raise — a corrupt committed trajectory should
    fail the agreement test loudly, not chart as empty."""
    rel = rel or path.name
    data = json.loads(path.read_text())
    points: list[Point] = []
    if isinstance(data, dict):
        # runner wrapper: {n, cmd, rc, tail, parsed?} or
        # {n_devices, rc, ok, skipped, tail}
        recs: list[dict] = []
        if isinstance(data.get("parsed"), dict):
            recs.append(data["parsed"])
        seen = {id(r) for r in recs}
        for rec in _tail_records(data.get("tail")):
            if id(rec) not in seen:
                recs.append(rec)
        # de-dup parsed vs tail copies of the same record
        uniq: list[dict] = []
        for rec in recs:
            if all(rec != u for u in uniq):
                uniq.append(rec)
        for i, rec in enumerate(uniq):
            p = _point_from_record(rec, rel, i)
            if p is not None:
                points.append(p)
        return points
    if not isinstance(data, list):
        raise ValueError(f"{rel}: expected list or wrapper dict, "
                         f"got {type(data).__name__}")
    for i, rec in enumerate(data):
        if not isinstance(rec, dict):
            continue
        p = _point_from_record(rec, rel, i)
        if p is not None:
            points.append(p)
        # legacy multi-facet shape (BENCH_delivery.json record 0):
        # {metric, hot_cache_rps, cold_origin_rps, speedup_x, ...} —
        # additionally expand each named *_rps facet into its own
        # point ("rps" itself is the labeled single-value key)
        metric = rec.get("metric")
        if isinstance(metric, str) and metric and "rps" not in rec:
            for k, v in rec.items():
                if not k.endswith("_rps") or k == "rps":
                    continue
                if isinstance(v, (int, float)) and not isinstance(v, bool):
                    points.append(Point(
                        file=rel, index=i, metric=f"{metric}_{k}",
                        value=float(v), timestamp=_ts(rec.get("timestamp")),
                        fallback=_is_fallback(rec), raw=rec))
    return points


def bench_files(root: Path) -> list[Path]:
    return sorted([*root.glob("BENCH_*.json"), *root.glob("MULTICHIP*.json")])


def load_trajectory(root: Path) -> list[Point]:
    points: list[Point] = []
    for path in bench_files(root):
        points.extend(parse_file(path, path.name))
    return points


@dataclass
class Regression:
    series: str
    metric: str
    file: str
    best: float
    latest: float
    ratio: float
    tolerance: float
    lower_is_better: bool

    def describe(self) -> str:
        direction = "rose" if self.lower_is_better else "fell"
        return (f"{self.series} [{self.file}]: latest {self.latest:g} "
                f"{direction} vs best {self.best:g} "
                f"(ratio {self.ratio:.2f}, tolerance {self.tolerance:g})")


def find_regressions(points: list[Point]) -> list[Regression]:
    """Latest gated point of every multi-point series vs the best gated
    prior point, beyond per-metric tolerance."""
    series: dict[str, list[Point]] = {}
    for p in points:
        if p.gated:
            series.setdefault(p.series_key, []).append(p)
    out: list[Regression] = []
    for key, pts in sorted(series.items()):
        if len(pts) < 2:
            continue
        # committed order is append order; fall back to timestamps when
        # a series spans files
        pts = sorted(pts, key=lambda p: (p.timestamp or 0.0, p.file,
                                         p.index))
        latest, prior = pts[-1], pts[:-1]
        lower = _is_lower_better(latest.metric)
        tol = _tolerance(latest.metric)
        if lower:
            best = min(p.value for p in prior)
            if best < _ABS_FLOOR_S and latest.value < _ABS_FLOOR_S:
                continue    # sub-floor latency jitter never gates
            if best <= 0:
                continue
            ratio = latest.value / best
            bad = ratio > 1.0 + tol
        else:
            best = max(p.value for p in prior)
            if best <= 0:
                continue
            ratio = latest.value / best
            bad = ratio < 1.0 - tol
        if bad:
            out.append(Regression(
                series=key, metric=latest.metric, file=latest.file,
                best=best, latest=latest.value, ratio=ratio,
                tolerance=tol, lower_is_better=lower))
    return out


def trend_report(root: Path | str | None = None) -> dict:
    """The full machine-readable report (CLI ``--json`` body)."""
    root = Path(root) if root is not None else _repo_root()
    points = load_trajectory(root)
    regressions = find_regressions(points)
    n_series = len({p.series_key for p in points if p.gated})
    return {
        "root": str(root),
        "files": [p.name for p in bench_files(root)],
        "points": len(points),
        "gated_points": sum(1 for p in points if p.gated),
        "series": n_series,
        "tolerance_default": config.BENCHTREND_TOL,
        "regressions": [vars(r) for r in regressions],
        "ok": not regressions,
    }


def summary_line(root: Path | str | None = None) -> str:
    """One-line trend stamp for bench records, e.g.
    ``trend ok: 61 points / 34 series, 0 regressions``. Never raises —
    a bench run must not die because the trend gate can't read a file."""
    try:
        rep = trend_report(root)
    except Exception as exc:   # noqa: BLE001 — stamp is garnish
        return f"trend unavailable: {exc}"
    state = "ok" if rep["ok"] else "REGRESSED"
    return (f"trend {state}: {rep['gated_points']} points / "
            f"{rep['series']} series, {len(rep['regressions'])} "
            f"regressions")


def _repo_root() -> Path:
    """The committed trajectory lives at the repo root (two levels up
    from this package module)."""
    return Path(__file__).resolve().parents[2]


def main(argv: list[str] | None = None) -> int:
    import argparse

    ap = argparse.ArgumentParser(
        prog="python -m vlog_tpu_torch.obs.benchtrend",
        description="Bench-trend regression gate over committed "
                    "BENCH_*.json / MULTICHIP*.json trajectories.")
    ap.add_argument("--check", action="store_true",
                    help="exit 1 if any series regressed")
    ap.add_argument("--root", default=None,
                    help="directory holding the bench files "
                         "(default: repo root)")
    ap.add_argument("--json", action="store_true", dest="as_json",
                    help="print the full machine-readable report")
    args = ap.parse_args(argv)
    rep = trend_report(args.root)
    if args.as_json:
        print(json.dumps(rep, indent=2))
    else:
        print(f"{rep['points']} points ({rep['gated_points']} gated) in "
              f"{len(rep['files'])} files, {rep['series']} series")
        for r in rep["regressions"]:
            print("REGRESSION: " + Regression(**r).describe())
        if rep["ok"]:
            print("no regressions beyond tolerance")
    return 1 if (args.check and not rep["ok"]) else 0


if __name__ == "__main__":
    raise SystemExit(main())
