"""Seeded inputs, made on the run's device: 4:2:0 video frames, Y4M clips,
speech-like audio and Whisper weights.

The frames are ``chip_smoke.py::_smooth_frames`` (a panning smooth
texture, a moving square, mild noise), and the audio its ``_asr_audio``
(voiced-like bursts over a quiet noise bed), both computed with torch on
the device instead of numpy on the host so that a 1080p clip or twenty
minutes of audio cost set-up milliseconds, not seconds. The seed sets the
noise and the phases; the sizes come from the traffic file, so every seed
asks for the same work.
"""

from __future__ import annotations

import math
from pathlib import Path

import numpy as np
import torch

Y4M_FRAME_TAG = b"FRAME\n"
# Frames generated per device call (and per host write).
FRAME_CHUNK = 24
AUDIO_RATE = 16000


def _gen(seed: int, stream: int, device: torch.device) -> torch.Generator:
    """A generator on ``device`` for one (seed, stream) pair: streams keep
    the noise of different chunks and inputs apart."""
    g = torch.Generator(device=device)
    g.manual_seed((int(seed) * 1_000_003 + int(stream)) % (1 << 63))
    return g


def smooth_frames(first: int, n: int, h: int, w: int, seed: int,
                  device: torch.device):
    """Frames ``first .. first + n - 1`` of the seeded clip as uint8 (n, h,
    w), (n, h/2, w/2), (n, h/2, w/2) tensors on ``device``. Frame k is the
    same whatever chunk it is made in (its noise comes from its own
    stream)."""
    dev = torch.device(device)
    phase = (seed % 997) * 7.0
    yy = torch.arange(h, device=dev, dtype=torch.float32)[:, None]
    xx = torch.arange(w, device=dev, dtype=torch.float32)[None, :]
    cy = torch.arange(h // 2, device=dev, dtype=torch.float32)[:, None] * 2
    cx = torch.arange(w // 2, device=dev, dtype=torch.float32)[None, :] * 2
    ys, us, vs = [], [], []
    for t in range(first, first + n):
        px, py = xx + 3 * t + phase, yy + 2 * t
        y = (110 + 50 * torch.sin(px / 23.0) * torch.cos(py / 31.0)
             + 30 * torch.sin((px + py) / 57.0))
        bx = (40 + 9 * t + int(phase)) % max(1, w - 96)
        by = (24 + 5 * t) % max(1, h - 96)
        y[by:by + 96, bx:bx + 96] = 220.0
        y = y + 1.5 * torch.randn((h, w), generator=_gen(seed, t, dev),
                                  device=dev)
        ys.append(torch.clamp(y, 0, 255).to(torch.uint8))
        cu = 128 + 30 * torch.sin((cx + 3 * t + phase) / 40.0)
        cv = 128 + 30 * torch.cos((cy + 2 * t) / 35.0)
        us.append(torch.clamp(cu.expand(h // 2, w // 2), 0, 255)
                  .to(torch.uint8))
        vs.append(torch.clamp(cv.expand(h // 2, w // 2), 0, 255)
                  .to(torch.uint8))
    return torch.stack(ys), torch.stack(us), torch.stack(vs)


def y4m_header(w: int, h: int, fps: int) -> bytes:
    return f"YUV4MPEG2 W{w} H{h} F{fps}:1 Ip A1:1 C420\n".encode()


def write_clip(path: Path, frames: int, h: int, w: int, fps: int, seed: int,
               device: torch.device) -> Path:
    """Write the seeded clip as a Y4M file (one device call per chunk)."""
    with open(path, "wb") as fp:
        fp.write(y4m_header(w, h, fps))
        for k in range(0, frames, FRAME_CHUNK):
            planes = [p.cpu().numpy() for p in
                      smooth_frames(k, min(FRAME_CHUNK, frames - k), h, w,
                                    seed, device)]
            for j in range(planes[0].shape[0]):
                fp.write(Y4M_FRAME_TAG)
                for p in planes:
                    fp.write(p[j].tobytes())
    return path


def read_clip(path: Path, first: int, n: int):
    """Frames ``first .. first + n - 1`` of a Y4M written by
    :func:`write_clip`, as numpy uint8 (n, h, w), (n, h/2, w/2) x 2."""
    data = np.memmap(path, dtype=np.uint8, mode="r")
    head = bytes(data[:256])
    line = head[:head.index(b"\n")].decode().split()
    w = int(next(t[1:] for t in line if t.startswith("W")))
    h = int(next(t[1:] for t in line if t.startswith("H")))
    start = len(head[:head.index(b"\n") + 1])
    fsize = len(Y4M_FRAME_TAG) + h * w * 3 // 2
    ys, us, vs = [], [], []
    for k in range(first, first + n):
        off = start + k * fsize + len(Y4M_FRAME_TAG)
        ys.append(np.array(data[off:off + h * w]).reshape(h, w))
        off += h * w
        us.append(np.array(data[off:off + h * w // 4]).reshape(h // 2, w // 2))
        off += h * w // 4
        vs.append(np.array(data[off:off + h * w // 4]).reshape(h // 2, w // 2))
    return np.stack(ys), np.stack(us), np.stack(vs)


def speech_audio(seconds: float, seed: int, stream: int,
                 device: torch.device) -> np.ndarray:
    """``seconds`` of 16 kHz mono float32: syllable-like bursts (a gliding
    100-220 Hz fundamental with 8 harmonics, 0.15-0.3 s each, 0.05-0.2 s
    apart: 3-5 syllables a second) over a quiet noise bed, speech to the
    last sample, so every 30 s window holds speech."""
    dev = torch.device(device)
    g = _gen(seed, 1 << 20 | stream, dev)
    n = int(round(seconds * AUDIO_RATE))
    # syllables: as many as could fit, their onsets a cumulative sum
    most = int(seconds / 0.2) + 2
    dur = 0.15 + 0.15 * torch.rand(most, generator=g, device=dev,
                                   dtype=torch.float64)
    gap = 0.05 + 0.15 * torch.rand(most, generator=g, device=dev,
                                   dtype=torch.float64)
    f0 = 100.0 + 120.0 * torch.rand(most, generator=g, device=dev,
                                    dtype=torch.float64)
    onset = 0.2 + torch.cumsum(dur + gap, 0) - (dur + gap)
    t = torch.arange(n, device=dev, dtype=torch.float64) / AUDIO_RATE
    idx = torch.clamp(torch.searchsorted(onset, t, right=True) - 1, 0, most - 1)
    tt = t - onset[idx]
    d = dur[idx]
    voiced = (tt >= 0) & (tt < d)
    inst = f0[idx] * (1 + 0.1 * tt / d)
    phase = 2 * math.pi * torch.cumsum(torch.where(voiced, inst, 0.0), 0) \
        / AUDIO_RATE
    burst = sum(torch.sin(k * phase) / k for k in range(1, 9))
    env = torch.where(voiced, torch.sin(math.pi * tt / d) ** 2, 0.0)
    x = 0.2 * env * burst + 1e-3 * torch.randn(
        n, generator=g, device=dev, dtype=torch.float64)
    return x.to(torch.float32).cpu().numpy()


def random_weights(shapes: dict[str, tuple], seed: int, device,
                   dtype=torch.float32) -> dict[str, torch.Tensor]:
    """Seeded weights for ``{name: shape}`` in one device call: every
    tensor a view of one normal draw scaled by 0.02, layer-norm weights
    1 and biases 0 (names ending ``layer_norm.weight``/``.bias``)."""
    dev = torch.device(device)
    total = sum(math.prod(s) for s in shapes.values())
    flat = torch.randn(total, generator=_gen(seed, 1 << 30, dev), device=dev,
                       dtype=dtype).mul_(0.02)
    out, at = {}, 0
    for name, shape in shapes.items():
        size = math.prod(shape)
        t = flat[at:at + size].view(shape)
        at += size
        if "layer_norm." in name:
            t.fill_(1.0 if name.endswith(".weight") else 0.0)
        out[name] = t
    return out
