"""Captions: a backlog of transcription jobs on one shared continuous-
batching Whisper engine (``vlog_tpu_torch.asr.engine.AsrEngine``),
each job through ``worker/transcribe.py::transcribe_audio_engine``.

The benchmark makes the weights on the device from the configuration's
seed, the byte-level vocabulary and the jobs' audio from the run's seed,
and hands the same to the program and to the reference
(``benchmark/reference/whisper.py``). ``concurrent`` job threads each
take the next job when theirs finishes; the engine takes one scheduler
lease per tick, as the worker daemon's does.

Completion events are the engine's ticks: each credits the upload audio
its windows cover, overlap counted once (window 0 its whole span, every
later window what lies past the previous one's end).

Each tick's beam search is recorded as it runs: the kept continuations
(scores and flat indices) at every step, copied on the card. The judge
follows them with the plain reference (``reference/whisper.py::
follow_beams``) on a sample of the window's windows drawn from the seed.
The control (``control()``): the program with TF32 switched on where it
turns it off.
"""

from __future__ import annotations

import contextlib
import threading
import time

import numpy as np

from benchmark import content
from benchmark.flops import PEAK_FP32_FLOPS, whisper_tick_flops
from benchmark.harness import Check, Window, log
from benchmark.reference import whisper as ref


class _Stop(Exception):
    """The window closed: the job thread leaves its job."""


def weight_shapes(cfg: dict) -> dict[str, tuple]:
    """Every parameter of the HF Whisper layout (``proj_out`` tied)."""
    d, mels = cfg["d_model"], cfg["num_mel_bins"]
    s = {"model.encoder.conv1.weight": (d, mels, 3),
         "model.encoder.conv1.bias": (d,),
         "model.encoder.conv2.weight": (d, d, 3),
         "model.encoder.conv2.bias": (d,),
         "model.encoder.embed_positions.weight":
             (cfg["max_source_positions"], d),
         "model.decoder.embed_tokens.weight": (cfg["vocab_size"], d),
         "model.decoder.embed_positions.weight":
             (cfg["max_target_positions"], d)}
    for side in ("encoder", "decoder"):
        s[f"model.{side}.layer_norm.weight"] = (d,)
        s[f"model.{side}.layer_norm.bias"] = (d,)
        ffn = cfg[f"{side}_ffn_dim"]
        for i in range(cfg[f"{side}_layers"]):
            n = f"model.{side}.layers.{i}"
            for a in (["self_attn"] if side == "encoder"
                      else ["self_attn", "encoder_attn"]):
                for proj in ("q_proj", "k_proj", "v_proj", "out_proj"):
                    s[f"{n}.{a}.{proj}.weight"] = (d, d)
                    if proj != "k_proj":
                        s[f"{n}.{a}.{proj}.bias"] = (d,)
                s[f"{n}.{a}_layer_norm.weight"] = (d,)
                s[f"{n}.{a}_layer_norm.bias"] = (d,)
            s[f"{n}.fc1.weight"] = (ffn, d)
            s[f"{n}.fc1.bias"] = (ffn,)
            s[f"{n}.fc2.weight"] = (d, ffn)
            s[f"{n}.fc2.bias"] = (d,)
            s[f"{n}.final_layer_norm.weight"] = (d,)
            s[f"{n}.final_layer_norm.bias"] = (d,)
    return s


def vocabulary(n_text: int) -> dict[str, int]:
    """The byte-level text vocabulary: the 256 byte characters, then
    distinct lowercase strings of 2 to 6 letters (a leading space on
    every third), a pure function of the id."""
    inv = ref._byte_map()
    vocab = {inv[b]: i for i, b in enumerate(sorted(inv))}
    letters = "abcdefghijklmnopqrstuvwxyz'"
    i = 0
    while len(vocab) < n_text:
        k, word = i, ""
        for _ in range(2 + i % 5):
            word += letters[k % 27]
            k //= 27
        if i % 3 == 0:
            word = inv[ord(" ")] + word[1:]
        vocab.setdefault(word, len(vocab))
        i += 1
    return vocab


def special_tokens(tok: dict) -> dict[int, str]:
    """id -> text of every special token, at the configuration's ids."""
    out = {tok["eot"]: "<|endoftext|>", tok["sot"]: "<|startoftranscript|>"}
    for i, lang in enumerate(tok["languages"]):
        out[tok["first_language"] + i] = f"<|{lang}|>"
    for name in ("translate", "transcribe", "startoflm", "startofprev",
                 "nocaptions", "notimestamps"):
        out[tok[name]] = f"<|{name}|>"
    for i in range(tok["timestamps"]):
        out[tok["timestamp_begin"] + i] = f"<|{0.02 * i:.2f}|>"
    return out


def window_credit(length_s: float, index: int, window_s: float,
                  stride_s: float) -> float:
    """Upload seconds window ``index`` adds to what the windows before it
    cover."""
    start = index * stride_s
    end = min(start + window_s, length_s)
    covered = 0.0 if index == 0 else min((index - 1) * stride_s + window_s,
                                         length_s)
    return max(0.0, end - max(start, covered))


class Driver:
    def __init__(self, cell, device, trace, profiler):
        self.cell = cell
        self.cfg = cell.config
        self.traffic = cell.traffic
        self.device = device
        self.trace = trace
        self.profiler = profiler
        self.model_cfg = self.cfg["model"]
        self.tok = dict(self.cfg["tokens"])
        self.tok["suppress"] = (list(self.cfg["generation"]["suppress_tokens"])
                                + [self.tok["notimestamps"]])
        self.tok["begin_suppress"] = list(
            self.cfg["generation"]["begin_suppress_tokens"])
        self.beam = int(self.cfg["env"]["VLOG_WHISPER_BEAM"])
        self.window_s = float(self.cfg["window_s"])
        self.stride_s = self.window_s - float(self.cfg["overlap_s"])
        self.prompt = [self.tok["sot"], self.tok[f"lang_{self.traffic['language']}"],
                       self.tok["transcribe"]]
        self.ticks: list[dict] = []       # every tick of the measured phase
        self.jobs_done: list[dict] = []
        self.errors: list[str] = []
        self.setup_parts: dict[str, float] = {}

    # -- set-up -----------------------------------------------------------
    def setup(self, seed: int) -> None:
        import torch

        from vlog_tpu_torch.asr import engine as engine_mod
        from vlog_tpu_torch.asr.engine import AsrEngine
        from vlog_tpu_torch.asr.load import (ByteLevelDecoder, WhisperAssets,
                                             derive_special_tokens)
        from vlog_tpu_torch.asr.model import WhisperConfig, WhisperModel
        from vlog_tpu_torch.parallel.scheduler import MeshScheduler

        self.torch = torch
        t0 = time.perf_counter()
        self.weights = content.random_weights(
            weight_shapes(self.model_cfg), self.cfg["weights_seed"],
            self.device)
        self.vocab = vocabulary(self.tok["sot"] - 1)
        self.special = special_tokens(self.tok)
        if self.device.type == "cuda":
            torch.cuda.synchronize()
        self.setup_parts["weights_s"] = time.perf_counter() - t0

        t0 = time.perf_counter()
        wcfg = WhisperConfig.from_hf(self.model_cfg)
        model = WhisperModel(wcfg, device=self.device).load_params(
            dict(self.weights))
        tokenizer = ByteLevelDecoder(self.vocab, self.special,
                                     unk_token="<|endoftext|>")
        hf = dict(self.model_cfg, decoder_start_token_id=self.tok["sot"],
                  eos_token_id=self.tok["eot"])
        gen = dict(self.cfg["generation"], decoder_start_token_id=self.tok["sot"],
                   eos_token_id=self.tok["eot"])
        tokens = derive_special_tokens(tokenizer, hf, gen)
        assets = WhisperAssets(cfg=wcfg, model=model, tokenizer=tokenizer,
                               tokens=tokens, model_name=self.cfg["name"])
        self.scheduler = (MeshScheduler() if self.device.type == "cuda"
                          else MeshScheduler(devices=["cpu"], slots=1))
        self.engine = AsrEngine(
            assets, scheduler=self.scheduler,
            batch_windows=int(self.cfg["env"]["VLOG_ASR_BATCH_WINDOWS"]))
        self.engine_mod = engine_mod
        self._install_taps()
        self.setup_parts["program_s"] = time.perf_counter() - t0

        t0 = time.perf_counter()
        lengths = list(self.traffic["job_seconds"])
        order = np.random.default_rng(seed).permutation(len(lengths))
        self.jobs = [{"key": f"job{i}", "seconds": float(lengths[j]),
                      "audio": content.speech_audio(lengths[j], seed, i,
                                                    self.device)}
                     for i, j in enumerate(order)]
        warm_s = self.window_s + self.stride_s * (
            int(self.cfg["env"]["VLOG_ASR_BATCH_WINDOWS"]) - 1)
        warm_audio = content.speech_audio(warm_s, seed, 999, self.device)
        self.setup_parts["audio_s"] = time.perf_counter() - t0

        t0 = time.perf_counter()
        self.profiler.warm(self.device)
        self._measuring = False
        from vlog_tpu_torch.worker.transcribe import transcribe_audio_engine

        self.transcribe = transcribe_audio_engine
        transcribe_audio_engine(warm_audio, self.engine, job_key="warm-up",
                                language=self.traffic["language"],
                                beam=self.beam)
        self.setup_parts["warm_up_s"] = time.perf_counter() - t0

    def _install_taps(self) -> None:
        """Record each tick of the measured phase (its windows, tokens,
        the beams kept at every step, end time) and, in a traced run,
        profile one tick."""
        from vlog_tpu_torch.asr import decode

        engine = self.engine
        orig_tick = engine._tick
        orig_rows = self.engine_mod.generate_rows
        orig_beam = decode._generate_beam
        orig_topk = decode.top_k_lower_index_first
        local = threading.local()
        self._orig_rows = orig_rows
        self._orig_decode = (decode, orig_beam, orig_topk)

        def rows(*a, **kw):
            local.calls = []
            t0 = time.perf_counter()
            toks, nsp = orig_rows(*a, **kw)
            local.out = (toks, nsp, time.perf_counter() - t0, local.calls)
            return toks, nsp

        def beam_search(model, mel, *a, **kw):
            steps = [] if self._measuring else None
            local.steps = steps
            try:
                out = orig_beam(model, mel, *a, **kw)
            finally:
                local.steps = None
            if steps is not None and getattr(local, "calls", None) is not None:
                local.calls.append((int(mel.shape[0]), steps))
            return out

        def topk(x, k):
            vals, idx = orig_topk(x, k)
            steps = getattr(local, "steps", None)
            if steps is not None:
                steps.append((vals.clone(), idx.clone()))
            return vals, idx

        decode._generate_beam = beam_search
        decode.top_k_lower_index_first = topk

        def tick(key, items, lease=None):
            local.out = None
            if not self._measuring:
                return orig_tick(key, items, lease)
            profile = (self.trace and not self.profiler.taken
                       and self.window.closed(time.perf_counter()))
            if profile:
                self.profiler.record(orig_tick, key, items, lease,
                                     meta={"windows": len(items)})
            else:
                orig_tick(key, items, lease)
            t = time.perf_counter()
            if local.out is None:
                return          # the tick failed: its jobs see the error
            toks, nsp, gen_s, calls = local.out
            self.ticks.append({
                "t": t, "n": len(items), "gen_s": gen_s, "beams": calls,
                "rows": engine.batch_log[-1]["rows"], "profiled": profile,
                "windows": [(it.job, it.index, it.start_s) for it in items],
                "tokens": toks[:len(items)], "no_speech": nsp[:len(items)]})
            self.window.add(t, sum(
                window_credit(self.lengths[it.job], it.index, self.window_s,
                              self.stride_s) for it in items))

        engine._tick = tick
        self.engine_mod.generate_rows = rows

    # -- the window -------------------------------------------------------
    def measure(self, seconds: float) -> Window:
        self.window = Window(seconds)
        self.lengths = {j["key"]: j["seconds"] for j in self.jobs}
        stop = threading.Event()
        nxt = iter(range(10 ** 9))
        lock = threading.Lock()

        def progress(done, total, msg):
            if stop.is_set():
                raise _Stop()

        def worker():
            while not stop.is_set():
                with lock:
                    k = next(nxt)
                job = self.jobs[k % len(self.jobs)]
                key = f"{job['key']}.{k // len(self.jobs)}"
                self.lengths[key] = job["seconds"]
                t0 = time.perf_counter()
                try:
                    cues, _, _ = self.transcribe(
                        job["audio"], self.engine, job_key=key,
                        language=self.traffic["language"], beam=self.beam,
                        progress_cb=progress)
                except _Stop:
                    return
                except Exception as exc:  # noqa: BLE001 — counted as failed
                    self.errors.append(f"{key}: {exc!r}")
                    return
                self.jobs_done.append({"key": key, "job": job, "cues": cues,
                                       "t0": t0, "t1": time.perf_counter()})

        self._measuring = True
        threads = [threading.Thread(target=worker, name=f"bench-job-{i}",
                                    daemon=True)
                   for i in range(int(self.traffic["concurrent"]))]
        for t in threads:
            t.start()
        deadline = time.perf_counter() + seconds + float(
            self.traffic["first_event_wait_s"])
        while time.perf_counter() < deadline:
            if self.window.closed(time.perf_counter()) and (
                    not self.trace or self.profiler.taken):
                break
            time.sleep(0.05)
        stop.set()
        for t in threads:
            t.join(timeout=120)
        self._measuring = False
        self.engine.close()
        self.engine_mod.generate_rows = self._orig_rows
        decode, orig_beam, orig_topk = self._orig_decode
        decode._generate_beam, decode.top_k_lower_index_first = \
            orig_beam, orig_topk
        if any(t.is_alive() for t in threads):
            self.errors.append("a job thread did not stop")
        return self.window

    def in_window(self) -> list[dict]:
        span = self.window.span
        if span is None:
            return []
        return [k for k in self.ticks if span[0] < k["t"] <= span[1]]

    def end_to_end(self) -> dict:
        return {"caption_audio_rate": self.window.rate()}

    def attempted_failed(self) -> tuple[int, int]:
        n = sum(k["n"] for k in self.in_window())
        return n, len(self.errors)

    # -- what the per-layer readers read ----------------------------------
    def flops_in_window(self) -> float:
        total = 0.0
        for k in self.in_window():
            lens = ref.generated_lengths(k["tokens"], self.tok["eot"])
            steps = int(lens.max()) if len(lens) else 0
            total += whisper_tick_flops(self.model_cfg, k["n"], self.beam,
                                        len(self.prompt), steps)
        return total

    def mfu_pct(self) -> float | None:
        span = self.window.span
        if span is None:
            return None
        return 100.0 * self.flops_in_window() / (span[1] - span[0]) \
            / PEAK_FP32_FLOPS

    # -- correctness ------------------------------------------------------
    def _sample(self, seed: int) -> list[tuple[dict, int]]:
        rows = [(k, i) for k in self.in_window() for i in range(k["n"])]
        if not rows:
            return []
        longest = max(rows, key=lambda r: int(ref.generated_lengths(
            r[0]["tokens"][r[1]:r[1] + 1], self.tok["eot"])[0]))
        rng = np.random.default_rng(seed)
        want = int(self.traffic["check_windows"])
        pick = [rows[i] for i in rng.choice(len(rows), min(want, len(rows)),
                                            replace=False)]
        if longest not in pick:
            pick[0] = longest
        return pick

    def reference_logits(self, audio: np.ndarray, gen: np.ndarray):
        """(logits over prompt + generated tokens, the window's
        no-speech probability) from the plain reference."""
        torch = self.torch
        x = torch.as_tensor(audio, device=self.device)
        mel = ref.log_mel(x, self.model_cfg["num_mel_bins"])
        enc = ref.encode(self.weights, self.model_cfg, mel)
        toks = torch.as_tensor(
            np.concatenate([np.tile(self.prompt, (len(gen), 1)), gen], 1),
            dtype=torch.int64, device=self.device)
        logits = ref.decoder_logits(self.weights, self.model_cfg, toks, enc)
        p0 = torch.softmax(logits[:, len(self.prompt) - 1].double(), -1)
        return logits, p0[:, self.tok["nocaptions"]].cpu().numpy()

    def _beams(self, tick: dict, i: int):
        """(scores, flat indices), each (steps, beam), of window ``i``'s
        beam search in ``tick``; None when it has no record."""
        if "beams_np" not in tick:
            tick["beams_np"] = []
            for rows, steps in tick["beams"]:
                if not steps:
                    continue
                vals = self.torch.stack([v for v, _ in steps], 1)
                idx = self.torch.stack([x for _, x in steps], 1)
                tick["beams_np"].append((rows, vals.cpu().numpy(),
                                         idx.cpu().numpy()))
        row0 = 0
        for rows, vals, idx in tick["beams_np"]:
            if i < row0 + rows:
                return vals[i - row0], idx[i - row0]
            row0 += rows
        return None

    def judge(self, seed: int) -> list[Check]:
        torch = self.torch
        faults = list(self.errors)
        ref.strict()
        sample = []
        for k, i in self._sample(seed):
            job, index, start = k["windows"][i]
            if abs(start - index * self.stride_s) > 1e-9:
                faults.append(f"{job} window {index} starts at {start}")
            beams = self._beams(k, i)
            if beams is None:
                faults.append(f"{job} window {index}: no beam search recorded")
                continue
            sample.append((job, index, k["tokens"][i], *beams))
        margins, gaps = [], []
        block = int(self.traffic["check_block"])
        sample.sort(key=lambda e: e[3].shape[0])
        groups = {}
        for e in sample:
            groups.setdefault(e[3].shape[0], []).append(e)
        for part in (g[b0:b0 + block] for g in groups.values()
                     for b0 in range(0, len(g), block)):
            x = torch.as_tensor(np.stack([
                ref.window_audio(self._audio(job), index * self.stride_s)
                for job, index, *_ in part]), device=self.device)
            with torch.inference_mode():
                mel = ref.log_mel(x, self.model_cfg["num_mel_bins"])
                m, g, ok = ref.follow_beams(
                    self.weights, self.model_cfg, mel, self.prompt, self.tok,
                    self.beam, np.stack([e[3] for e in part]),
                    np.stack([e[4] for e in part]),
                    np.stack([e[2] for e in part]))
            margins += list(m)
            gaps += list(g)
            faults += [f"{e[0]} window {e[1]}: the served tokens are no "
                       "final beam" for e, good in zip(part, ok) if not good]
        if sample:
            distinct = len({e[2].tobytes() for e in sample})
            log(f"captions: {distinct} distinct token sequences among "
                f"{len(sample)} sampled windows")
        else:
            faults.append("no window was decoded in the window")
        faults += self._cue_faults(seed)
        for f in faults[:5]:
            log(f"fault: {f}")
        lim = self.cfg["limits"]
        return [Check("beam_margin", float(max(margins, default=np.inf)),
                      lim["beam_margin"]),
                Check("score_gap", float(max(gaps, default=np.inf)),
                      lim["score_gap"]),
                Check("served_faults", float(len(faults)), 0.0)]

    def _audio(self, key: str) -> np.ndarray:
        base = key.split(".")[0]
        return next(j["audio"] for j in self.jobs if j["key"] == base)

    def _cue_faults(self, seed: int) -> list[str]:
        """Served cues of sampled finished jobs against the reference's
        cues from the served tokens: every window decoded, every cue
        equal."""
        torch = self.torch
        done = [j for j in self.jobs_done
                if self.window.span and j["t1"] > self.window.span[0]]
        if not done:
            return []
        rng = np.random.default_rng(seed + 1)
        pick = [done[i] for i in rng.choice(
            len(done), min(int(self.traffic["check_jobs"]), len(done)),
            replace=False)]
        text = ref.TextDecoder(self.vocab, self.special)
        out = []
        for job in pick:
            key = job["key"]
            rows = {}
            for k in self.ticks:
                for i, (j, index, _) in enumerate(k["windows"]):
                    if j == key:
                        rows[index] = k["tokens"][i]
            n = len(job["job"]["audio"])
            want = 1 + max(0, -(-(n - int(self.window_s * ref.SAMPLE_RATE))
                                // int(self.stride_s * ref.SAMPLE_RATE)))
            if sorted(rows) != list(range(want)):
                out.append(f"{key}: windows {sorted(rows)[:5]}.. of {want}")
                continue
            gen = np.stack([rows[i] for i in range(want)])
            nsp = []
            for b0 in range(0, want, int(self.traffic["check_block"])):
                audio = np.stack([ref.window_audio(
                    job["job"]["audio"], i * self.stride_s)
                    for i in range(b0, min(want, b0 + int(
                        self.traffic["check_block"])))])
                with torch.inference_mode():
                    lg, p = self.reference_logits(
                        audio, gen[b0:b0 + len(audio)])
                    del lg
                nsp += list(p)
            per_window = []
            for i in range(want):
                cues = []
                if nsp[i] <= 0.6:
                    for s, e, ids in ref.segments(gen[i], self.tok,
                                                  self.window_s):
                        t0 = i * self.stride_s
                        cues.append((t0 + s, t0 + e, text.decode(
                            [t for t in ids if t < self.tok["sot"]])))
                per_window.append(cues)
            want_cues = ref.stitch(per_window)
            got = [(c.start_s, c.end_s, c.text) for c in job["cues"]]
            if got != want_cues:
                bad = sum(a != b for a, b in zip(got, want_cues)) + abs(
                    len(got) - len(want_cues))
                out.append(f"{key}: {bad} cues differ")
        return out

    def close(self) -> None:
        engine = getattr(self, "engine", None)   # None when set-up failed
        if engine is not None:
            engine.close()


@contextlib.contextmanager
def control():
    """The control, planted in the program: float32 products in TF32
    (one precision below the configuration's float32 with TF32 off),
    switched on where the program switches it off."""
    import torch

    from vlog_tpu_torch import device

    orig = device.strict_fp32

    def tf32() -> None:
        torch.backends.cuda.matmul.allow_tf32 = True
        torch.backends.cudnn.allow_tf32 = True

    device.strict_fp32 = tf32
    try:
        yield
    finally:
        device.strict_fp32 = orig
