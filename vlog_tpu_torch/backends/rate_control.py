"""Closed-loop rate control: per-batch QP adaptation toward a bitrate.

The reference hits ladder bitrate targets by delegating VBR to
x264/NVENC (`-b:v`/`-maxrate`, worker/hwaccel.py:660-731). Here the
control loop is explicit: observe achieved bits after each GOP batch,
pick the next QP. The DSP takes QP as a *traced* per-frame value
(ops/transform.py), so stepping costs no recompile.

Design (round 4, replacing the log-bracket search): the rate curve of a
real encoder is NOT smooth — MB decimation, skip thresholds, and dead
zones produce CLIFFS where bits drop several-fold across one QP step
(measured: 64k -> 8k bytes/frame between QP 27 and 28 on noisy content).
Two structural choices make the controller exact there:

- **Integer-QP rate estimates.** ``frame_qps(n)`` realizes a fractional
  working point q as a Bresenham mix of floor(q) and floor(q)+1 frames,
  so the achieved rate is a LINEAR blend of the two integers' rates.
  The controller therefore estimates bytes/frame per INTEGER QP (EMA,
  updated by attributing each batch observation to the two integers in
  proportion to their mix), instead of curve-fitting fractional points.
- **Analytic dither fraction.** Once adjacent integers (qa, qa+1)
  bracket the target, the mix fraction is solved directly:
  f = (r(qa) - target) / (r(qa) - r(qa+1)), and q = qa + f. One step
  lands ON target even when the target sits inside a cliff no single QP
  can reach. Non-adjacent brackets bisect at integers; no bracket
  extrapolates on the textbook bits-halve-per-6-QP slope, clamped to
  ±2*max_step per batch — calibration included, so a cliff can cost at
  most one bounded-error batch, never a 5x overshoot burn.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field

import numpy as np


@dataclass
class RateController:
    """One per rung. ``observe()`` after each batch; read ``qp`` (or
    ``frame_qps``) before the next."""

    target_bps: int            # 0 = constant-QP mode (no adaptation)
    fps: float
    init_qp: int
    min_qp: int = 10
    max_qp: int = 48
    damping: float = 0.6       # kept for API compat (unused)
    max_step: int = 4          # extrapolation clamp (x2 applied)
    ema_alpha: float = 0.5     # per-QP estimate update weight
    band: float = 0.15         # +-15% of target counts as converged
    # Debt payback horizon: overspend from a scene cut / noise burst is
    # recovered over this many frames by steering the working setpoint
    # below nominal (and vice versa for undershoot). Without it the
    # loop re-converges to NOMINAL after every spike, so bursty content
    # averages 25-60% hot even though each quiet batch sits in-band —
    # x264's VBR pays its debt back the same way.
    payback_horizon_frames: float = 96.0
    # Converged-phase downward probe size. 1 for integer-QP video codecs
    # (cliffs sit between adjacent QPs; one step either converges or
    # forms an adjacent bracket for the analytic dither). Controllers on
    # finer, smoother scales (AAC scalefactors span ~170 steps) raise it.
    converged_down_step: float = 1.0

    _q: float = field(init=False)
    _obs: dict = field(default_factory=dict, init=False)   # int qp -> bpf
    _order: list = field(default_factory=list, init=False)
    _calibrating: bool = field(default=True, init=False)
    _hunting: bool = field(default=True, init=False)
    _debt_bytes: float = field(default=0.0, init=False)
    _proxy_alpha: float = field(default=0.0, init=False)

    def __post_init__(self) -> None:
        self._q = float(self.init_qp)

    @property
    def hunting(self) -> bool:
        """True until an observation lands within 1.5x of target. While
        hunting, the backend consumes batches SYNCHRONOUSLY (no
        one-batch-in-flight overlap): with a batch in flight every
        correction lags one extra batch, and a calibration jump past a
        rate cliff would burn two 5x batches instead of one."""
        return self.target_bps > 0 and self._hunting

    @property
    def qp(self) -> int:
        return int(round(self._q))

    @qp.setter
    def qp(self, value: int) -> None:
        self._q = float(value)

    @property
    def target_bytes_per_frame(self) -> float:
        return self.target_bps / 8.0 / self.fps if self.fps else 0.0

    # ---- device-side in-chain cascade (ops/bitproxy.py) --------------
    # The chain programs adapt QP per FRAME on device from a bits proxy;
    # this controller is the outer loop and owns the bytes-per-proxy
    # calibration both backends share.

    def device_rc_params(self) -> dict:
        """The rc pytree a chain-ladder dispatch takes (alpha 0 until
        the first batch calibrates -> device runs open-loop)."""
        return {"budget": np.float32(
                    max(self.target_bytes_per_frame, 1.0)),
                "alpha": np.float32(self._proxy_alpha)}

    def calibrate_proxy(self, batch_bytes: float, cost_sum: float) -> None:
        """EMA the realized bytes-per-proxy-unit from one chain batch.
        No-op for constant-QP rungs (no target) or empty batches."""
        if self.target_bps <= 0 or cost_sum <= 0:
            return
        a = batch_bytes / cost_sum
        self._proxy_alpha = (a if self._proxy_alpha == 0
                             else 0.5 * self._proxy_alpha + 0.5 * a)

    def frame_qps(self, n: int) -> np.ndarray:
        """Per-frame integer QPs whose mix realizes the fractional
        working point (evenly interleaved)."""
        lo = math.floor(self._q)
        frac = self._q - lo
        i = np.arange(n)
        bump = ((i + 1) * frac).astype(np.int64) - (i * frac).astype(
            np.int64)
        return np.clip(lo + bump, self.min_qp, self.max_qp).astype(
            np.int32)

    # ------------------------------------------------------------------
    def _touch(self, q: int) -> None:
        if q in self._order:
            self._order.remove(q)
        self._order.append(q)
        while len(self._order) > 12:          # bounded, recency-kept
            self._obs.pop(self._order.pop(0), None)

    def _upd(self, q: int, bpf: float, weight: float = 1.0) -> None:
        bpf = max(bpf, 1.0)
        if q in self._obs:
            self._obs[q] += self.ema_alpha * weight * (bpf - self._obs[q])
        else:
            self._obs[q] = bpf
        self._touch(q)

    def _attribute(self, bpf: float, lo: int, f: float) -> None:
        """Fold one batch observation into the integer estimates for the
        realized (lo, lo+1) mix with fraction ``f`` of frames at lo+1."""
        lo = int(min(max(lo, self.min_qp), self.max_qp))
        hi = int(min(lo + 1, self.max_qp))
        if f < 1e-6 or hi == lo:
            self._upd(lo, bpf)
            return
        rlo, rhi = self._obs.get(lo), self._obs.get(hi)
        if rlo is None and rhi is None:
            self._upd(lo, bpf)
            self._upd(hi, bpf)
            return
        if rlo is None:
            if f < 0.85:       # enough mass at lo to imply its rate
                self._upd(lo, (bpf - f * rhi) / (1.0 - f))
            else:              # nearly all frames ran at hi
                self._upd(hi, bpf)
            return
        if rhi is None:
            if f > 0.15:       # enough mass at hi to imply its rate
                self._upd(hi, (bpf - (1.0 - f) * rlo) / f)
            else:
                self._upd(lo, bpf)
            return
        # both known: distribute the prediction error by mix share
        pred = (1.0 - f) * rlo + f * rhi
        err = bpf - pred
        self._upd(lo, rlo + (1.0 - f) * err)
        self._upd(hi, rhi + f * err)

    def _predicted(self) -> float | None:
        lo = math.floor(self._q)
        f = self._q - lo
        rlo, rhi = self._obs.get(lo), self._obs.get(lo + 1)
        if f < 1e-6:
            return rlo
        if rlo is None or rhi is None:
            return None
        return (1.0 - f) * rlo + f * rhi

    def observe(self, bytes_out: int, n_frames: int,
                frame_qps: np.ndarray | None = None) -> int:
        """Feed achieved bytes for ``n_frames`` frames; returns next QP.

        ``frame_qps``: the integer QPs the batch was ACTUALLY encoded at
        (the array ``frame_qps()`` returned when the batch was staged).
        The backend runs one batch in flight, so by observe time the
        working point has already moved — attributing to ``self._q``
        would mislabel every observation by one batch (the failure mode
        ADVICE round-3 flagged on the HEVC path). Without it the current
        working point is assumed."""
        if self.target_bps <= 0 or n_frames <= 0 or self.fps <= 0:
            return self.qp
        bpf = bytes_out / n_frames
        if frame_qps is not None and len(frame_qps) > 0:
            qs = np.asarray(frame_qps).reshape(-1)[:n_frames]
            lo = int(qs.min())
            f = float(np.mean(qs > lo))
            q_real = lo + f
        else:
            lo = math.floor(self._q)
            f = self._q - lo
            q_real = self._q
        self._attribute(bpf, lo, f)
        nominal = max(self.target_bytes_per_frame, 1e-9)
        # Anti-windup, two layers: a single batch can book at most 3x
        # its nominal budget of debt/credit (one cliff batch must not
        # dominate the integral), and the integral itself is clamped to
        # what the (clamped) setpoint offset can actually pay back —
        # a long stretch of un-payable credit/debt (content pinned at a
        # QP rail) cannot bank thousands of frames of rail-riding.
        batch_budget = nominal * int(n_frames)
        # credit is inherently <= 1x budget (bytes_out >= 0); no
        # per-batch clamp needed on that side
        per_batch = min(float(bytes_out) - batch_budget,
                        3.0 * batch_budget)
        # integral caps mirror the setpoint clamp below: debt pays back
        # at up to 0.5x nominal/frame, credit spends at only 0.15x —
        # each side bounded by what one horizon can actually recover
        self._debt_bytes += per_batch
        self._debt_bytes = min(
            max(self._debt_bytes,
                -0.15 * nominal * self.payback_horizon_frames),
            0.5 * nominal * self.payback_horizon_frames)
        calibrating, self._calibrating = self._calibrating, False
        self._hunting = (abs(math.log2(max(bpf, 1.0) / nominal))
                         > math.log2(1.5))
        # Steady-state setpoint = nominal minus accumulated debt
        # amortized over the payback horizon, clamped to [0.5, 1.5]x
        # nominal so a giant spike can't spiral QP to the rails. Debt
        # accrues always (calibration bits were really spent) and
        # steers every post-calibration batch — a scene-cut batch that
        # blows past 1.5x nominal is exactly when payback must engage,
        # not pause. Only the calibration batch itself is exempt (its
        # step math is the direction-asymmetric transient logic).
        if calibrating:
            target = nominal
        else:
            # Asymmetric setpoint clamp (the integral sibling of the
            # asymmetric step rule): paying back overshoot pushes the
            # setpoint down to 0.5x freely — raising QP is always safe —
            # but banked credit raises it at most 15%, because SPENDING
            # credit means stepping down toward rate cliffs, and a
            # cliff batch costs more than the credit was worth.
            target = min(max(
                nominal - self._debt_bytes / self.payback_horizon_frames,
                0.5 * nominal), 1.15 * nominal)

        # converged: the just-measured rate sits inside the band
        if abs(math.log2(max(bpf, 1.0) / target)) <= math.log2(
                1 + self.band):
            return self.qp

        over = {q: r for q, r in self._obs.items() if r > target}
        under = {q: r for q, r in self._obs.items() if r <= target}
        if over and under:
            qa = max(over)                     # highest QP still over
            qb = min(under)                    # lowest QP at/under
            if qa >= qb:
                # contradicts bits-decrease-with-QP: the content moved;
                # keep only what this batch just taught us — the
                # REALIZED (lo, lo+1) pair, which with a batch in flight
                # is not floor(self._q)
                keep = {q: self._obs[q]
                        for q in (lo, lo + 1) if q in self._obs}
                self._obs = dict(keep)
                self._order = list(keep)
            elif qb - qa == 1:
                # adjacent bracket: rate mixes linearly in the dither
                # fraction — solve it exactly (cliff-proof)
                f = (over[qa] - target) / max(over[qa] - under[qb], 1e-9)
                self._q = qa + min(max(f, 0.0), 0.999)
                return self.qp
            else:
                # wide bracket: log-rate interpolation, snapped to an
                # INTEGER probe strictly inside (smooth content lands
                # near the answer in one step; cliffs degenerate toward
                # bisection, and every probe tightens the bracket)
                l_lo = math.log2(max(over[qa], 1.0))
                l_hi = math.log2(max(under[qb], 1.0))
                t = (math.log2(target) - l_lo) / min(l_hi - l_lo, -1e-9)
                probe = round(qa + t * (qb - qa))
                self._q = float(min(max(probe, qa + 1), qb - 1))
                return self.qp

        # No (usable) bracket: textbook slope, ASYMMETRICALLY capped.
        # Downward moves (spending more bits) walk at most max_step per
        # batch: a rate cliff below costs a mildly-under batch instead
        # of a 5x overshoot burn (each step lands a bracket point, so
        # the analytic dither takes over the moment the target is
        # straddled). Upward moves (cutting bits) jump the whole way
        # while calibrating — overshoot recovery must be immediate.
        ratio = max(bpf, 1.0) / target
        step = 6.0 * math.log2(ratio)
        if step < 0:
            # halve the remaining distance on bracketless downward moves
            # while far from target: any target is reached in O(log)
            # batches of cheap UNDER-target encodes, and a cliff at the
            # far end is approached, never leapt onto (the 5x-burn batch
            # a full jump used to cost). CONVERGED operation probes one
            # QP at a time: near the working point the rate curve's
            # cliffs are exactly where a -3 model step lands 5x hot, and
            # a single step either converges or forms an adjacent
            # bracket for the analytic dither to solve.
            step = step / 2.0 if self._hunting or calibrating \
                else max(step, -self.converged_down_step)
        elif not calibrating:
            step = min(step, 2.0 * self.max_step)
        base = q_real if frame_qps is not None else self._q
        self._q = float(int(round(
            min(max(base + step, float(self.min_qp)),
                float(self.max_qp)))))
        return self.qp
