"""TorchBackend(device="cpu") against JaxBackend on a tiny Y4M at
constant QP (tests/test_torch_backend_rc.py runs rate control on).

Same explicit rungs (an identity rung and a scaled one), segment 1 s at
10 fps (10-frame I+P chains, 3 dispatches), CABAC, deblock on. JaxBackend
is pinned to one device (``grid_for_run`` -> None, its single-device
result) so both stage the same batches and rate-control schedule.
Tolerance: every file of the CMAF tree byte-identical, except the JAX
backend's rate-control journal (``rc_journal.jsonl``), which the port
does not write (no resume in this slice).
"""

from __future__ import annotations

from pathlib import Path

from tests.fixtures.media import make_y4m

JAX_ONLY = {"rc_journal.jsonl"}


def _files(root: Path) -> dict[str, bytes]:
    return {str(p.relative_to(root)): p.read_bytes()
            for p in sorted(root.rglob("*")) if p.is_file()}


def run_both(tmp_path: Path, monkeypatch, bitrate: int):
    from vlog_tpu import config as jconfig
    from vlog_tpu.backends.jax_backend import JaxBackend
    from vlog_tpu.media.probe import get_video_info as jax_probe
    from vlog_tpu.parallel import scheduler
    from vlog_tpu_torch import config as tconfig
    from vlog_tpu_torch.backends.torch_backend import TorchBackend
    from vlog_tpu_torch.media.probe import get_video_info as torch_probe

    monkeypatch.setattr(scheduler, "grid_for_run", lambda *a, **k: None)
    src = make_y4m(tmp_path / "src.y4m", n_frames=30, width=128, height=96,
                   fps=10)
    spec = (("96p", 96, bitrate, 30), ("64p", 64, bitrate // 2, 31))
    jr = tuple(jconfig.QualityRung(n, h, b, 0, base_qp=q) for n, h, b, q in spec)
    tr = tuple(tconfig.QualityRung(n, h, b, 0, base_qp=q) for n, h, b, q in spec)

    jb = JaxBackend()
    jplan = jb.plan(jax_probe(src), jr, tmp_path / "jax",
                    segment_duration_s=1.0, thumbnail=False)
    jres = jb.run(jplan)
    tb = TorchBackend(device="cpu")
    tplan = tb.plan(torch_probe(src), tr, tmp_path / "torch",
                    segment_duration_s=1.0)
    tres = tb.run(tplan)
    assert tplan.gop_len == jplan.gop_len == 10
    return jres, tres


def assert_trees_identical(tmp_path: Path) -> None:
    want, got = _files(tmp_path / "jax"), _files(tmp_path / "torch")
    assert set(want) - set(got) == JAX_ONLY
    assert set(got) <= set(want)
    assert sum(k.endswith(".m4s") for k in got) == 6
    for rel, data in got.items():
        assert data == want[rel], f"{rel} differs ({len(data)} vs {len(want[rel])} bytes)"


def test_cmaf_tree_byte_identical_at_constant_qp(tmp_path, monkeypatch):
    jres, tres = run_both(tmp_path, monkeypatch, bitrate=0)
    assert_trees_identical(tmp_path)
    assert [r.achieved_bitrate for r in tres.rungs] == \
        [r.achieved_bitrate for r in jres.rungs]
    from vlog_tpu_torch.media import hls

    hls.validate_master_playlist(tmp_path / "torch" / "master.m3u8")
