"""BENCHMARK.json's validation and the result line's schema."""

import copy
import json

import pytest

from benchmark import harness, spec


@pytest.fixture
def good():
    return json.loads((spec.ROOT / "BENCHMARK.json").read_text())


def test_the_repository_spec_validates(good):
    spec.validate(good)
    cells = {w["name"] for w in good["workloads"]}
    assert cells == {"hevc-ladder.1080p-clips", "whisper-small.backlog"}
    for m in good["per_layer"]:
        assert m["moves"] in {e["name"] for e in good["end_to_end"]}


@pytest.mark.parametrize("break_it", [
    lambda s: s["end_to_end"][0].update(unit="frames per s"),
    lambda s: s["end_to_end"][0].update(bound=0.3),
    lambda s: s["end_to_end"][0].update(bound=0.001),
    lambda s: s["per_layer"][0].update(name="bad name"),
    lambda s: s["per_layer"][0].update(moves="nothing"),
    lambda s: s["per_layer"][0].update(why="extra key"),
    lambda s: s["per_layer"][0].update(name="no.reader.here"),
    lambda s: s["workloads"][0].update(chips=2),
    lambda s: s["workloads"][0].update(traffic="missing"),
    lambda s: s.update(run_seconds=52),
    lambda s: s["end_to_end"].pop(),
    lambda s: s["configs"][0].update(file="elsewhere/x.json"),
    lambda s: s.update(command=["python3", "/abs/run.py"]),
])
def test_a_broken_spec_is_refused(good, break_it):
    bad = copy.deepcopy(good)
    break_it(bad)
    with pytest.raises(spec.SpecError):
        spec.validate(bad)


def test_result_line_schema():
    checks = [harness.Check("beam_margin", 1e-6, 1e-4),
              harness.Check("served_faults", 0.0, 0.0)]
    line = harness.result_line(
        correct=True, attempted=10, failed=0,
        metrics={"caption_audio_rate": {"value": 90.5, "unit": "audio_s/s"}},
        device={"platform": "gpu", "kind": "NVIDIA H100 80GB HBM3",
                "count": 1, "memory_peak_bytes": 1},
        checks=checks, breakdown={"device_ops": [], "idle_gaps": []})
    out = json.loads(line)
    assert list(out) == ["correct", "attempted", "failed", "metrics",
                         "device", "breakdown", "checks"]
    assert out["checks"]["beam_margin"] == {"value": 1e-6, "limit": 1e-4}
    assert all(c.ok for c in checks)
    assert not harness.Check("x", 2.0, 1.0).ok
