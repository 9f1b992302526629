"""The port's H.264 chain step (``parallel/ladder.py::ladder_chain_program``)
against the benchmark's frozen plain H.264 DSP
(``benchmark/reference/h264_core.py``), on the CPU: bit for bit on every
level, MV, in-chain QP and filtered reconstruction, the bit proxy's
cost within rtol 1e-5; and the reference loads nothing of the port or of
JAX."""

from __future__ import annotations

import ast
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from benchmark.reference import h264_core
from tests.test_torch_backend import one_torch_thread  # noqa: F401
from vlog_tpu_torch.parallel import ladder

ROOT = Path(__file__).resolve().parents[1]
N, T, H, W = 2, 6, 48, 64
LEVELS = ("i_luma_dc", "i_luma_ac", "i_chroma_dc", "i_chroma_ac", "p_luma",
          "p_chroma_dc", "p_chroma_ac", "mv")


def _content(kind: str, seed: int):
    """(N, T, H, W) uint8 planes and (N, T, H/2, W/2) chroma: independent
    uniform noise a frame, or a smooth random texture panning by (t, 2t)
    pixels a frame with mild noise."""
    g = torch.Generator().manual_seed(seed)

    def plane(h, w):
        if kind == "random":
            return torch.randint(0, 256, (N, T, h, w), generator=g,
                                 dtype=torch.int32)
        base = torch.rand((N, 1, h // 4 + 8, w // 4 + 8), generator=g)
        big = torch.nn.functional.interpolate(base, scale_factor=4,
                                              mode="bilinear")[:, 0] * 200
        frames = [big[:, t:t + h, 2 * t:2 * t + w] for t in range(T)]
        x = torch.stack(frames, 1) + 3 * torch.randn((N, T, h, w),
                                                     generator=g)
        return torch.clamp(x + 20, 0, 255).to(torch.int32)

    return tuple(plane(h, w).to(torch.uint8)
                 for h, w in ((H, W), (H // 2, W // 2), (H // 2, W // 2)))


def _recording(monkeypatch) -> list:
    """Each frame's final reconstruction of the port's chain step, in
    order: the encoder's, replaced by the filter's when it runs."""
    recs: list = []
    enc, penc, dbk = (ladder.encode_frame, ladder.encode_p_frame,
                      ladder.deblock_frame)

    def encode_frame(*a, **kw):
        out = enc(*a, **kw)
        recs.append([out[f"recon_{k}"] for k in "yuv"])
        return out

    def encode_p_frame(*a, **kw):
        out = penc(*a, **kw)
        recs.append([out[f"recon_{k}"] for k in "yuv"])
        return out

    def deblock_frame(*a, **kw):
        out = dbk(*a, **kw)
        recs[-1] = list(out)
        return out

    monkeypatch.setattr(ladder, "encode_frame", encode_frame)
    monkeypatch.setattr(ladder, "encode_p_frame", encode_p_frame)
    monkeypatch.setattr(ladder, "deblock_frame", deblock_frame)
    return recs


@pytest.mark.parametrize("rc", [False, True], ids=["const_qp", "rc"])
@pytest.mark.parametrize("deblock", [False, True], ids=["raw", "deblock"])
@pytest.mark.parametrize("kind", ["random", "moving"])
def test_chain_step_matches_the_frozen_reference(monkeypatch, kind, deblock,
                                                 rc):
    y, u, v = _content(kind, seed=7 + 2 * deblock + rc)
    rng = np.random.default_rng(11)
    qps = rng.integers(24, 40, (N, T)).astype(np.int32)
    # a small budget and a live alpha drive the cascade's QP upward
    rcp = {"budget": np.float32(40.0), "alpha": np.float32(0.5)} \
        if rc else None
    recs = _recording(monkeypatch)
    fn, mats = ladder.ladder_chain_program((("48p", H, W, 30),), H, W,
                                           search=8, deblock=deblock,
                                           device="cpu")
    got = fn(y, u, v, mats, {"48p": qps},
             None if rcp is None else {"48p": rcp})["48p"]
    with torch.inference_mode():
        want = h264_core.encode_chain(y, u, v, torch.as_tensor(qps),
                                      search=8, deblock=deblock, rc=rcp)
    for name in LEVELS:
        assert torch.equal(got[name].to(torch.int32), want[name]), name
    assert len(recs) == T
    for t, rec in enumerate(recs):
        for k, plane in zip("yuv", rec):
            assert torch.equal(plane.to(torch.uint8),
                               want[f"recon_{k}"][:, t]), (t, k)
    if rc:
        assert torch.equal(got["qp_eff"].to(torch.int32), want["qp_eff"])
        # the cascade moved QPs off the plan
        assert (want["qp_eff"][:, 1:] != torch.as_tensor(qps)[:, 1:]).any()
        torch.testing.assert_close(got["cost"], want["cost"], rtol=1e-5,
                                   atol=0)
    else:
        assert "qp_eff" not in got and "qp_eff" not in want
    # the motion field is not all zero, and deblocking acts
    assert want["mv"].abs().sum() > 0
    if deblock:
        raw = h264_core.encode_chain(y, u, v, torch.as_tensor(qps), search=8,
                                     deblock=False, rc=rcp)
        assert not torch.equal(raw["recon_y"], want["recon_y"])


def _imports(path: Path) -> set[str]:
    out = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module:
            out.add(node.module.split(".")[0])
    return out


def test_the_h264_reference_loads_nothing_of_the_port_or_jax():
    for name in ("h264_core.py", "h264_deblock.py", "cmaf_avc.py"):
        got = _imports(ROOT / "benchmark" / "reference" / name)
        assert not got & {"vlog_tpu", "vlog_tpu_torch", "jax", "jaxlib"}, \
            (name, got)
    code = ("import sys; import benchmark.reference.h264_core, "
            "benchmark.reference.cmaf_avc; "
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'flax', 'vlog_tpu', 'vlog_tpu_torch')); "
            "print(bad); sys.exit(1 if bad else 0)")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
