"""The seams of the shared ladder run (``backends/ladder_run.py``) that
the benchmark taps (its judges and its planted faults): the H.264 and
HEVC runs build their ladder program through the module attributes
``torch_backend.ladder_chain_grid`` and
``hevc_path.hevc_chain_ladder_grid``, and make their CMAF segment bytes
through ``torch_backend.media_segment`` and ``hevc_path.media_segment``,
each looked up when the run calls it. Each case wraps one of them in a
counting pass-through, runs a tiny CPU job through
``TorchBackend(device="cpu").run`` and holds the published tree, byte
for byte, to an unwrapped run's.

Source: a seeded 64x48 Y4M, 18 frames at 6 fps, segments of 1 s
(6-frame I+P chains), one chain per dispatch (3 dispatches), rungs 48p
(identity) and 32p (scaled), rate control on.
"""

from __future__ import annotations

from pathlib import Path

import pytest

from tests.fixtures.media import make_y4m
from tests.test_torch_backend import _files, one_torch_thread  # noqa: F401

SEAMS = [
    ("torch_backend", "ladder_chain_grid", "h264"),
    ("hevc_path", "hevc_chain_ladder_grid", "h265"),  # slowlane-ok: 64x48, 18 frames
    ("torch_backend", "media_segment", "h264"),
    ("hevc_path", "media_segment", "h265"),  # slowlane-ok: 64x48, 18 frames
]


@pytest.fixture(scope="module")
def source(tmp_path_factory) -> Path:
    return make_y4m(tmp_path_factory.mktemp("seams") / "src.y4m",
                    n_frames=18, width=64, height=48, fps=6, seed=3)


def _run(src: Path, out: Path, codec: str) -> None:
    from vlog_tpu_torch import config
    from vlog_tpu_torch.backends.torch_backend import TorchBackend
    from vlog_tpu_torch.media.probe import get_video_info

    rungs = (config.QualityRung("48p", 48, 120_000, 0, base_qp=30),
             config.QualityRung("32p", 32, 60_000, 0, base_qp=31))
    be = TorchBackend(device="cpu")
    plan = be.plan(get_video_info(src), rungs, out, segment_duration_s=1.0,
                   frame_batch=6, codec=codec)
    res = be.run(plan, resume=False)
    assert len(res.dispatches) == 3
    assert [r.segment_count for r in res.rungs] == [3, 3]


@pytest.fixture(scope="module")
def plain_trees(source, tmp_path_factory):
    """Each codec's tree from an unwrapped run, made once."""
    trees = {}

    def tree(codec: str) -> dict[str, bytes]:
        if codec not in trees:
            out = tmp_path_factory.mktemp(f"plain_{codec}")
            _run(source, out, codec)
            trees[codec] = _files(out)
        return trees[codec]

    return tree


@pytest.mark.parametrize("module,name,codec", SEAMS,
                         ids=[f"{m}.{n}" for m, n, _ in SEAMS])
def test_the_run_calls_the_seam_at_run_time(source, plain_trees, tmp_path,
                                            monkeypatch, module, name, codec):
    import importlib

    mod = importlib.import_module(f"vlog_tpu_torch.backends.{module}")
    orig, calls = getattr(mod, name), []

    def counting(*args, **kwargs):
        calls.append(name)
        return orig(*args, **kwargs)

    monkeypatch.setattr(mod, name, counting)
    _run(source, tmp_path / "out", codec)
    assert calls, f"{module}.{name} was never called"
    want, got = plain_trees(codec), _files(tmp_path / "out")
    assert set(got) == set(want)
    for rel, data in got.items():
        assert data == want[rel], rel
