"""Colorspace conversion and 4:2:0 chroma resampling (port of
``vlog_tpu/ops/colorspace.py``), on the caller's device.

Planes are planar: luma ``(..., H, W)``, chroma ``(..., H/2, W/2)``.
BT.601 and BT.709, studio range (Y in [16, 235], C in [16, 240]) or full
range; RGB is float [0, 1] ``(..., H, W, 3)``.

The arithmetic follows what XLA's CPU compiler makes of the JAX
functions, so both packages give the same bits:

- a division by a constant is a multiplication by its float32
  reciprocal;
- ``a * b + c`` inside a fused elementwise loop is one fused multiply-add
  (``_fma``: the float32 product is exact in float64, so one rounding of
  the float64 sum to float32 gives the fused result; a double rounding
  can differ from it, with a chance of about 2^-29 per element);
- the 3x3 colour products are chains ``fma(x2, m2, fma(x1, m1, x0 * m0))``
  in ``yuv420_to_rgb``; in ``rgb_to_yuv420`` XLA keeps a dot whose first
  two output channels are ``(x0 m0 + x1 m1) + x2 m2`` without fusion and
  whose third is the fused chain (measured at 96x128 and 720x1280 RGB
  frames; other shapes may take another code path there and differ in
  the last bit of a few values, which moves a byte by at most 1);
- the inverse matrices are the float32 values ``jnp.linalg.inv`` returns
  for the forward ones (``_INV``; tests/test_torch_thumbnail.py checks
  them against the JAX package).
"""

from __future__ import annotations

import numpy as np
import torch

# Luma coefficients (Kr, Kb) per matrix standard.
_KR_KB = {
    "bt601": (0.299, 0.114),
    "bt709": (0.2126, 0.0722),
}

# float32 inverses of the forward matrices, as jnp.linalg.inv gives them
_INV = {
    "bt601": ((1.0, -1.6596204e-08, 1.402),
              (1.0, -0.3441363, -0.7141363),
              (1.0, 1.772, 5.078317e-10)),
    "bt709": ((0.99999994, 5.9691088e-09, 1.5748),
              (0.99999994, -0.18732427, -0.46812424),
              (0.9999999, 1.8556, 6.1037326e-08)),
}


def _matrices(standard: str) -> tuple[np.ndarray, np.ndarray]:
    """(forward RGB -> YCbCr, inverse), float32 (3, 3)."""
    try:
        kr, kb = _KR_KB[standard]
    except KeyError:
        raise ValueError(f"unknown colorspace standard {standard!r}") from None
    kg = 1.0 - kr - kb
    fwd = np.array([
        [kr, kg, kb],
        [-0.5 * kr / (1 - kb), -0.5 * kg / (1 - kb), 0.5],
        [0.5, -0.5 * kg / (1 - kr), -0.5 * kb / (1 - kr)],
    ], dtype=np.float32)
    return fwd, np.array(_INV[standard], dtype=np.float32)


def _fma(a: torch.Tensor, b: float, c) -> torch.Tensor:
    """float32 ``a * b + c`` with one rounding (``b`` a float32 value)."""
    c = c.double() if isinstance(c, torch.Tensor) else float(c)
    return (a.double() * float(b) + c).float()


def _recip(x: float) -> float:
    return float(np.float32(1.0) / np.float32(x))


def _to_uint8(x: torch.Tensor) -> torch.Tensor:
    return torch.clamp(torch.round(x), 0, 255).to(torch.uint8)


def _up2(p: torch.Tensor) -> torch.Tensor:
    """Nearest-neighbour doubling of the last two axes."""
    return p.repeat_interleave(2, dim=-2).repeat_interleave(2, dim=-1)


def _box2(p: torch.Tensor) -> torch.Tensor:
    """float32 2x2 box mean over the last two axes, summed as XLA's CPU
    reduction sums."""
    h, w = p.shape[-2], p.shape[-1]
    p = p.to(torch.float32).reshape(*p.shape[:-2], h // 2, 2, w // 2, 2)
    a, b = p[..., 0, :, 0], p[..., 0, :, 1]
    c, d = p[..., 1, :, 0], p[..., 1, :, 1]
    return ((a + b) + (c + d)) * 0.25


def rgb_to_yuv420(rgb: torch.Tensor, *, standard: str = "bt709",
                  full_range: bool = False):
    """RGB float [0, 1] (..., H, W, 3) -> planar uint8 (Y, U, V) 4:2:0.

    H and W must be even; chroma is the 2x2 box mean."""
    fwd, _ = _matrices(standard)
    x = rgb.to(torch.float32)
    x0, x1, x2 = x[..., 0], x[..., 1], x[..., 2]

    def row(d: int) -> torch.Tensor:
        m = fwd[d]
        if d < 2:
            return (x0 * float(m[0]) + x1 * float(m[1])) + x2 * float(m[2])
        return _fma(x2, m[2], _fma(x1, m[1], x0 * float(m[0])))

    y, cb, cr = row(0), row(1), row(2)
    if full_range:
        yq = y * 255.0
        cq_scale = 255.0
    else:
        yq = _fma(y, 219.0, 16.0)
        cq_scale = 224.0
    cbq = _fma(cb, cq_scale, 128.0)
    crq = _fma(cr, cq_scale, 128.0)
    return _to_uint8(yq), _to_uint8(_box2(cbq)), _to_uint8(_box2(crq))


def yuv420_to_rgb(y: torch.Tensor, u: torch.Tensor, v: torch.Tensor, *,
                  standard: str = "bt709", full_range: bool = False
                  ) -> torch.Tensor:
    """Planar uint8 YUV 4:2:0 -> RGB float [0, 1] (..., H, W, 3); chroma
    upsampled by nearest-neighbour doubling."""
    _, inv = _matrices(standard)
    yf = y.to(torch.float32)
    uf, vf = _up2(u.to(torch.float32)), _up2(v.to(torch.float32))
    if full_range:
        yl = yf * _recip(255.0)
        cscale = 255.0
    else:
        yl = (yf - 16.0) * _recip(219.0)
        cscale = 224.0
    cb = (uf - 128.0) * _recip(cscale)
    cr = (vf - 128.0) * _recip(cscale)
    rgb = torch.stack([_fma(cr, m[2], _fma(cb, m[1], yl * float(m[0])))
                       for m in inv], dim=-1)
    return torch.clamp(rgb, 0.0, 1.0)


def yuv420_to_yuv444(y: torch.Tensor, u: torch.Tensor, v: torch.Tensor):
    """Upsample chroma to luma resolution (nearest)."""
    return y, _up2(u), _up2(v)


def yuv444_to_yuv420(y: torch.Tensor, u: torch.Tensor, v: torch.Tensor):
    """Downsample chroma with a 2x2 box filter (float32 mean, rounded
    half to even to uint8)."""
    return y, _to_uint8(_box2(u)), _to_uint8(_box2(v))
