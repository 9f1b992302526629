"""TorchBackend(device="cpu") against JaxBackend on a tiny Y4M at
constant QP (tests/test_torch_backend_rc.py runs rate control on).

Same explicit rungs (an identity rung and a scaled one), segment 1 s at
10 fps (10-frame I+P chains, 3 dispatches), CABAC, deblock on, the
default thumbnail. JaxBackend is pinned to one device (``grid_for_run``
-> None, its single-device result) so both stage the same batches and
rate-control schedule. Tolerance: every file of the tree byte-identical
(``thumbnail.jpg`` included), except the rate-control journal's ``cost``
fields: each is the float32 sum of the device bit proxy (``log2`` terms,
whose float32 values differ between XLA's and PyTorch's ``log2`` and
whose sum order differs, ROADMAP Queue C item 2), held to a relative
1e-5; every other journal field, and the journal's line structure, are
exact.
"""

from __future__ import annotations

import json
import math
from pathlib import Path

import pytest
import torch

from tests.fixtures.media import make_y4m


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The port's CPU runs are many small eager ops: intra-op threads only
    add overhead, and oversubscribe the cores when several test workers
    run at once. (Modules that import this fixture get it too.)"""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _files(root: Path) -> dict[str, bytes]:
    return {str(p.relative_to(root)): p.read_bytes()
            for p in sorted(root.rglob("*")) if p.is_file()}


def rung_pair(bitrate: int):
    """The same two rungs in each package's config type."""
    from vlog_tpu import config as jconfig
    from vlog_tpu_torch import config as tconfig

    spec = (("96p", 96, bitrate, 30), ("64p", 64, bitrate // 2, 31))
    return (tuple(jconfig.QualityRung(n, h, b, 0, base_qp=q) for n, h, b, q in spec),
            tuple(tconfig.QualityRung(n, h, b, 0, base_qp=q) for n, h, b, q in spec))


def run_both(tmp_path: Path, monkeypatch, bitrate: int, *, n_frames: int = 30,
             jax_rungs=None, torch_rungs=None, audio_adts=None, **plan_opts):
    """JaxBackend into tmp_path/jax, TorchBackend(device="cpu") into
    tmp_path/torch, same source, rungs and plan options, no resume."""
    from vlog_tpu.backends.jax_backend import JaxBackend
    from vlog_tpu.media.probe import get_video_info as jax_probe
    from vlog_tpu.parallel import scheduler
    from vlog_tpu_torch.backends.torch_backend import TorchBackend
    from vlog_tpu_torch.media.probe import get_video_info as torch_probe

    monkeypatch.setattr(scheduler, "grid_for_run", lambda *a, **k: None)
    src = make_y4m(tmp_path / "src.y4m", n_frames=n_frames, width=128,
                   height=96, fps=10)
    jr, tr = rung_pair(bitrate)
    jr, tr = jax_rungs or jr, torch_rungs or tr

    jb = JaxBackend()
    jplan = jb.plan(jax_probe(src), jr, tmp_path / "jax",
                    segment_duration_s=1.0, **plan_opts)
    jplan.audio_adts = audio_adts
    jres = jb.run(jplan, resume=False)
    tb = TorchBackend(device="cpu")
    tplan = tb.plan(torch_probe(src), tr, tmp_path / "torch",
                    segment_duration_s=1.0, **plan_opts)
    tplan.audio_adts = audio_adts
    tres = tb.run(tplan, resume=False)
    assert tplan.gop_len == jplan.gop_len
    return jres, tres


COST_RTOL = 1e-5
JOURNAL = "rc_journal.jsonl"


def assert_journals_match(want: bytes, got: bytes) -> None:
    """Same lines and fields; ``cost`` within COST_RTOL (see the module
    docstring); the bytes are identical when no cost differs."""
    wl, gl = want.decode().splitlines(), got.decode().splitlines()
    assert len(gl) == len(wl), (len(gl), len(wl))
    assert gl[0] == wl[0]                              # header
    for w, g in zip(wl[1:], gl[1:]):
        wo, go = json.loads(w), json.loads(g)
        assert go["k"] == wo["k"] and set(go["obs"]) == set(wo["obs"])
        for rung, ob in go["obs"].items():
            ref = wo["obs"][rung]
            assert {k: v for k, v in ob.items() if k != "cost"} == \
                {k: v for k, v in ref.items() if k != "cost"}
            if ref["cost"] is None or ob["cost"] is None:
                assert ob["cost"] is ref["cost"] is None
            else:
                assert math.isclose(ob["cost"], ref["cost"],
                                    rel_tol=COST_RTOL), (ob["cost"], ref["cost"])


def assert_same_files(want_root: Path, got_root: Path) -> dict[str, bytes]:
    """Every file of both trees byte-identical, the journal held as
    :func:`assert_journals_match` says; returns the files."""
    want, got = _files(want_root), _files(got_root)
    assert set(got) == set(want)
    for rel, data in got.items():
        if rel == JOURNAL:
            assert_journals_match(want[rel], data)
            continue
        assert data == want[rel], f"{rel} differs ({len(data)} vs {len(want[rel])} bytes)"
    return got


def assert_trees_identical(tmp_path: Path) -> None:
    got = assert_same_files(tmp_path / "jax", tmp_path / "torch")
    assert sum(k.endswith(".m4s") for k in got) == 6
    assert {JOURNAL, "thumbnail.jpg"} <= set(got)


def test_cmaf_tree_byte_identical_at_constant_qp(tmp_path, monkeypatch):
    jres, tres = run_both(tmp_path, monkeypatch, bitrate=0)
    assert tres.gop_len == 10
    assert_trees_identical(tmp_path)
    assert [r.achieved_bitrate for r in tres.rungs] == \
        [r.achieved_bitrate for r in jres.rungs]
    from vlog_tpu_torch.media import hls

    hls.validate_master_playlist(tmp_path / "torch" / "master.m3u8")
