"""Fixtures of the benchmark's CPU tests: a checkout-shaped copy of the
benchmark with the cells cut to sizes a CPU runs in seconds.

Run from the repository root:

    python -m pytest benchmark/tests -q -p no:cacheprovider
"""

from __future__ import annotations

import json
import shutil
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]

TINY_WHISPER = {"d_model": 64, "encoder_layers": 1, "decoder_layers": 1,
                "encoder_attention_heads": 2, "decoder_attention_heads": 2,
                "encoder_ffn_dim": 128, "decoder_ffn_dim": 128,
                "max_target_positions": 64}
TINY_RUNGS = [
    {"name": "96p", "height": 96, "width": 128, "qp": 30,
     "video_bitrate": 400000, "audio_bitrate": 64000},
    {"name": "48p", "height": 48, "width": 64, "qp": 31,
     "video_bitrate": 200000, "audio_bitrate": 64000}]


def _tiny(root: Path) -> None:
    cfg = root / "benchmark" / "configs"
    tr = root / "benchmark" / "traffic"
    h = json.loads((cfg / "hevc-ladder.json").read_text())
    h["rungs"] = TINY_RUNGS
    h["env"] = dict(h["env"], VLOG_TPU_FRAME_BATCH="24",
                    VLOG_SEGMENT_DURATION="1")
    (cfg / "hevc-ladder.json").write_text(json.dumps(h))
    t = json.loads((tr / "1080p-clips.json").read_text())
    t.update(height=96, width=128, frames=48, first_event_wait_s=120,
             check_jobs=[0, 1])
    (tr / "1080p-clips.json").write_text(json.dumps(t))
    w = json.loads((cfg / "whisper-small.json").read_text())
    w["model"].update(TINY_WHISPER)
    w["env"] = dict(w["env"], VLOG_ASR_BATCH_WINDOWS="4",
                    VLOG_WHISPER_BEAM="2")
    (cfg / "whisper-small.json").write_text(json.dumps(w))
    t = json.loads((tr / "backlog.json").read_text())
    t.update(concurrent=2, job_seconds=[55, 80, 105], check_windows=64,
             check_block=8, first_event_wait_s=120)
    (tr / "backlog.json").write_text(json.dumps(t))


@pytest.fixture
def tiny_root(tmp_path: Path) -> Path:
    """A copy of BENCHMARK.json and the benchmark's data files, its cells
    cut to CPU sizes (the code is the real package's)."""
    root = tmp_path / "checkout"
    (root / "benchmark").mkdir(parents=True)
    shutil.copy(ROOT / "BENCHMARK.json", root / "BENCHMARK.json")
    for sub in ("configs", "traffic", "metrics"):
        shutil.copytree(ROOT / "benchmark" / sub, root / "benchmark" / sub)
    _tiny(root)
    return root


@pytest.fixture
def cuda():
    """Skip unless a CUDA device is there (decided here, not at import)."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")
