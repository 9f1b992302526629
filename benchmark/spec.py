"""``BENCHMARK.json``: validation at start, and the lookup of every file
that belongs to one configuration, one traffic mix or one per-layer
metric by its name.

A cell ``<config>.<traffic>`` runs the configuration file the entry
names (``benchmark/configs/<config>.json``) under the traffic file
``benchmark/traffic/<traffic>.json``; the configuration's ``driver`` key
names the module (``benchmark/drivers/<name>.py``) that runs that kind
of system. Each per-layer metric is read by
``benchmark/metrics/<metric name>.py``. A later change adds a cell, a
configuration or a metric by adding files and entries; nothing here
changes.
"""

from __future__ import annotations

import importlib.util
import json
import re
from dataclasses import dataclass
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
TOP_KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
            "end_to_end", "per_layer"}
CONFIG_KEYS = {"name", "source", "file", "reduced", "why"}
CELL_KEYS = {"name", "config", "traffic", "chips", "why"}
E2E_KEYS = {"name", "unit", "better", "bound", "source"}
LAYER_KEYS = {"name", "unit", "better", "source", "layer", "moves"}
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}
MAX_BOUND = 0.25
MIN_BOUND = 0.01


class SpecError(ValueError):
    """``BENCHMARK.json`` breaks the benchmark's contract."""


def _text(v, what: str, most: int = 200) -> str:
    if not isinstance(v, str) or not 1 <= len(v) <= most \
            or "\n" in v or "\t" in v:
        raise SpecError(f"{what}: 1 to {most} characters on one line")
    return v


def _name(v, what: str) -> str:
    if not isinstance(v, str) or not NAME.match(v):
        raise SpecError(f"{what}: {v!r} is not a name")
    return v


def _keys(entry, want: set, extra: set, what: str) -> None:
    if not isinstance(entry, dict):
        raise SpecError(f"{what}: not an object")
    have = set(entry)
    if not want <= have or have - want - extra:
        raise SpecError(f"{what}: keys {sorted(have)}, want {sorted(want)}"
                        + (f" (+ {sorted(extra)})" if extra else ""))


def _unique(entries, what: str) -> None:
    names = [e["name"] for e in entries]
    dup = {n for n in names if names.count(n) > 1}
    if dup:
        raise SpecError(f"{what}: names {sorted(dup)} repeat")


def validate(spec: dict, root: Path = ROOT) -> dict:
    """Raise :class:`SpecError` unless ``spec`` keeps the contract and
    every file it implies exists under ``root``; returns ``spec``."""
    _keys(spec, TOP_KEYS, set(), "BENCHMARK.json")
    cmd = spec["command"]
    if not isinstance(cmd, list) or not 1 <= len(cmd) <= 32:
        raise SpecError("command: a list of 1 to 32 strings")
    for word in cmd:
        _text(word, "command word")
        if word.startswith("/") or ".." in word.split("/"):
            raise SpecError(f"command word {word!r} leaves the checkout")
    paths = spec["paths"]
    if not isinstance(paths, list) or not 1 <= len(paths) <= 16:
        raise SpecError("paths: 1 to 16 directories")
    for p in paths:
        if not isinstance(p, str) or not PATH.match(p) or p.startswith("/") \
                or ".." in p.split("/"):
            raise SpecError(f"paths: {p!r}")

    def under_paths(f: str) -> bool:
        return any(f == p or f.startswith(p.rstrip("/") + "/") for p in paths)

    rs = spec["run_seconds"]
    if not isinstance(rs, int) or isinstance(rs, bool) or not 1 <= rs <= 51:
        raise SpecError("run_seconds: a whole number from 1 to 51")

    configs = spec["configs"]
    if not isinstance(configs, list) or not 1 <= len(configs) <= 24:
        raise SpecError("configs: 1 to 24 entries")
    files = set()
    for c in configs:
        _keys(c, CONFIG_KEYS, set(), "config")
        _name(c["name"], "config name")
        _text(c["source"], f"{c['name']}: source")
        _text(c["why"], f"{c['name']}: why")
        if not under_paths(c["file"]) or not (root / c["file"]).is_file():
            raise SpecError(f"{c['name']}: file {c['file']!r} is not a file "
                            "under paths")
        if c["file"] in files:
            raise SpecError(f"{c['name']}: file shared with another config")
        files.add(c["file"])
        red = c["reduced"]
        if not isinstance(red, list) or len(red) > 16:
            raise SpecError(f"{c['name']}: reduced is a list of at most 16")
        for k in red:
            _name(k, f"{c['name']}: reduced key")
    _unique(configs, "configs")
    config_names = {c["name"] for c in configs}

    cells = spec["workloads"]
    if not isinstance(cells, list) or not 1 <= len(cells) <= 24:
        raise SpecError("workloads: 1 to 24 cells")
    pairs = set()
    for w in cells:
        _keys(w, CELL_KEYS, set(), "workload")
        _name(w["name"], "workload name")
        _name(w["traffic"], f"{w['name']}: traffic")
        _text(w["why"], f"{w['name']}: why")
        if w["config"] not in config_names:
            raise SpecError(f"{w['name']}: unknown config {w['config']!r}")
        if w["chips"] not in (1, 4):
            raise SpecError(f"{w['name']}: chips 1 or 4")
        if (w["config"], w["traffic"]) in pairs:
            raise SpecError(f"{w['name']}: config and traffic repeat")
        pairs.add((w["config"], w["traffic"]))
        if not traffic_path(w["traffic"], root).is_file():
            raise SpecError(f"{w['name']}: no traffic file "
                            f"{traffic_path(w['traffic'], root)}")
    _unique(cells, "workloads")
    if sum(w["chips"] == 4 for w in cells) > max(1, len(cells) // 4):
        raise SpecError("too many four-chip cells")
    used = {w["config"] for w in cells}
    if used != config_names:
        raise SpecError(f"configs used by no cell: {config_names - used}")
    cell_names = {w["name"] for w in cells}

    e2e, layer = spec["end_to_end"], spec["per_layer"]
    if not isinstance(e2e, list) or not 1 <= len(e2e) <= 16:
        raise SpecError("end_to_end: 1 to 16 metrics")
    if not isinstance(layer, list) or not 1 <= len(layer) <= 128:
        raise SpecError("per_layer: 1 to 128 metrics")
    for m in e2e + layer:
        is_e2e = m in e2e
        _keys(m, E2E_KEYS if is_e2e else LAYER_KEYS, {"workloads"},
              "metric")
        _name(m["name"], "metric name")
        if not isinstance(m["unit"], str) or not UNIT.match(m["unit"]):
            raise SpecError(f"{m['name']}: unit {m['unit']!r}")
        if m["better"] not in ("lower", "higher"):
            raise SpecError(f"{m['name']}: better is lower or higher")
        if m["source"] not in SOURCES or (
                is_e2e and m["source"] not in ("host_clock", "device_trace")):
            raise SpecError(f"{m['name']}: source {m['source']!r}")
        for c in m.get("workloads", []):
            if c not in cell_names:
                raise SpecError(f"{m['name']}: unknown workload {c!r}")
        if is_e2e:
            b = m["bound"]
            if not isinstance(b, (int, float)) or not MIN_BOUND <= b <= MAX_BOUND:
                raise SpecError(f"{m['name']}: bound {b!r} outside "
                                f"[{MIN_BOUND}, {MAX_BOUND}]")
        else:
            _text(m["layer"], f"{m['name']}: layer")
            if m["moves"] not in {x["name"] for x in e2e}:
                raise SpecError(f"{m['name']}: moves unknown metric "
                                f"{m['moves']!r}")
            if not metric_path(m["name"], root).is_file():
                raise SpecError(f"{m['name']}: no reader "
                                f"{metric_path(m['name'], root)}")
    _unique(e2e + layer, "metrics")
    if "setup_s" not in {m["name"] for m in e2e}:
        raise SpecError("end_to_end lacks setup_s")
    for w in cells:
        ends = [m["name"] for m in e2e if w["name"] in
                m.get("workloads", [w["name"]])]
        layers = [m["name"] for m in layer if w["name"] in
                  m.get("workloads", [w["name"]])]
        if "setup_s" not in ends or len(ends) < 2 or not layers:
            raise SpecError(f"{w['name']}: needs setup_s, another end-to-end "
                            "metric and a per-layer metric")
    for m in layer:
        moved = next(x for x in e2e if x["name"] == m["moves"])
        for c in m.get("workloads", []):
            if c not in moved.get("workloads", [c]):
                raise SpecError(f"{m['name']}: {c} does not report "
                                f"{m['moves']}")
    return spec


def load(root: Path = ROOT) -> dict:
    path = root / "BENCHMARK.json"
    if path.stat().st_size > 64 << 10:
        raise SpecError("BENCHMARK.json is over 64 KiB")
    return validate(json.loads(path.read_text()), root)


def traffic_path(traffic: str, root: Path = ROOT) -> Path:
    return root / "benchmark" / "traffic" / f"{traffic}.json"


def metric_path(metric: str, root: Path = ROOT) -> Path:
    return root / "benchmark" / "metrics" / f"{metric}.py"


@dataclass
class Cell:
    """One cell with everything its run needs, found by name."""

    name: str
    chips: int
    config: dict            # the configuration file's object
    traffic: dict           # the traffic file's object
    end_to_end: list[dict]  # the metrics this cell reports
    per_layer: list[dict]
    run_seconds: int


def cell(spec: dict, name: str, root: Path = ROOT) -> Cell:
    try:
        w = next(c for c in spec["workloads"] if c["name"] == name)
    except StopIteration:
        raise SpecError(f"unknown workload {name!r}") from None
    entry = next(c for c in spec["configs"] if c["name"] == w["config"])
    reports = lambda m: name in m.get("workloads", [name])  # noqa: E731
    return Cell(
        name=name, chips=w["chips"],
        config=json.loads((root / entry["file"]).read_text()),
        traffic=json.loads(traffic_path(w["traffic"], root).read_text()),
        end_to_end=[m for m in spec["end_to_end"] if reports(m)],
        per_layer=[m for m in spec["per_layer"] if reports(m)],
        run_seconds=spec["run_seconds"])


def load_reader(metric: str, root: Path = ROOT):
    """The ``read(run)`` function of ``benchmark/metrics/<metric>.py``."""
    path = metric_path(metric, root)
    mod_name = "benchmark_metric_" + re.sub(r"\W", "_", metric)
    spec = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def load_driver(driver: str):
    """``benchmark/drivers/<driver>.py``'s module."""
    _name(driver, "driver")
    return importlib.import_module(f"benchmark.drivers.{driver}")
