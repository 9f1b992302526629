"""A cell, a configuration, a traffic mix and a metric added as files and
entries are found by name; nothing else changes."""

import json

from benchmark import spec


def test_added_files_are_found_by_name(tiny_root):
    s = json.loads((tiny_root / "BENCHMARK.json").read_text())
    cfg = json.loads((tiny_root / "benchmark/configs/hevc-ladder.json").read_text())
    cfg["name"] = "hevc-ladder-b"
    (tiny_root / "benchmark/configs/hevc-ladder-b.json").write_text(json.dumps(cfg))
    tr = json.loads((tiny_root / "benchmark/traffic/1080p-clips.json").read_text())
    tr["frames"] = 24
    (tiny_root / "benchmark/traffic/short-clips.json").write_text(json.dumps(tr))
    (tiny_root / "benchmark/metrics/pipeline.jobs.py").write_text(
        "def read(run):\n    return 7.0\n")
    s["configs"].append({"name": "hevc-ladder-b", "source": "https://example.org/b",
                         "file": "benchmark/configs/hevc-ladder-b.json",
                         "reduced": [], "why": "a second deployment"})
    s["workloads"].append({"name": "hevc-ladder-b.short-clips",
                           "config": "hevc-ladder-b", "traffic": "short-clips",
                           "chips": 1, "why": "one-chain clips"})
    for m in s["end_to_end"]:
        if m["name"] == "ladder_fps":
            m["workloads"].append("hevc-ladder-b.short-clips")
    s["per_layer"].append({"name": "pipeline.jobs", "unit": "jobs",
                           "better": "higher", "source": "program_counter",
                           "layer": "worker pipeline", "moves": "ladder_fps",
                           "workloads": ["hevc-ladder-b.short-clips"]})
    (tiny_root / "BENCHMARK.json").write_text(json.dumps(s))

    loaded = spec.load(tiny_root)
    cell = spec.cell(loaded, "hevc-ladder-b.short-clips", tiny_root)
    assert cell.config["name"] == "hevc-ladder-b"
    assert cell.traffic["frames"] == 24
    assert [m["name"] for m in cell.end_to_end] == ["ladder_fps", "setup_s"]
    assert [m["name"] for m in cell.per_layer] == ["pipeline.jobs"]
    assert spec.load_reader("pipeline.jobs", tiny_root)(None) == 7.0
    assert spec.load_driver(cell.config["driver"]).Driver.__name__ == "Driver"
