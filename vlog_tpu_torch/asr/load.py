"""Load Whisper checkpoints from the HuggingFace on-disk layout, without
``transformers`` or ``safetensors``.

A checkpoint directory holds ``config.json``, ``model.safetensors`` (read
here: an 8-byte little-endian header length, a JSON header, raw
little-endian tensors) or ``pytorch_model.bin`` (``torch.load`` with
``weights_only=True``), ``generation_config.json`` and the tokenizer
files ``WhisperTokenizer.save_pretrained`` writes. Only decoding is
needed from the tokenizer: :class:`ByteLevelDecoder` stands in for
``WhisperTokenizer.decode`` as the engine and the worker call it. The
weights are converted and quantized as ``vlog_tpu/asr/load.py`` does
them (the int8 ``q`` and ``scale`` are the same numpy operations, so the
same bytes). Nothing is fetched.
"""

from __future__ import annotations

import json
import re
import threading
from dataclasses import dataclass, field
from functools import lru_cache
from pathlib import Path

import numpy as np
import torch

from vlog_tpu_torch.asr.model import QuantTensor, WhisperConfig, WhisperModel


class ModelLoadError(RuntimeError):
    pass


@dataclass(frozen=True)
class SpecialTokens:
    """Token ids steering generation (HF generation_config semantics)."""

    sot: int                 # <|startoftranscript|>
    eot: int                 # <|endoftext|>
    transcribe: int
    translate: int
    no_timestamps: int
    timestamp_begin: int     # first <|0.00|> id; 1500 ids follow (20ms grid)
    no_speech: int | None
    language_ids: dict[str, int] = field(default_factory=dict)
    suppress: tuple[int, ...] = ()
    begin_suppress: tuple[int, ...] = ()

    def language_token(self, language: str) -> int:
        try:
            return self.language_ids[language]
        except KeyError:
            raise ModelLoadError(
                f"language {language!r} not in model vocabulary") from None


@dataclass
class WhisperAssets:
    cfg: WhisperConfig
    model: WhisperModel
    tokenizer: "ByteLevelDecoder"
    tokens: SpecialTokens
    model_name: str


# --------------------------------------------------------------------------
# Tokenizer (decode only)
# --------------------------------------------------------------------------

@lru_cache(maxsize=1)
def bytes_to_unicode() -> dict[int, str]:
    """GPT-2's byte -> printable character map (byte-level BPE)."""
    bs = (list(range(ord("!"), ord("~") + 1))
          + list(range(ord("¡"), ord("¬") + 1))
          + list(range(ord("®"), ord("ÿ") + 1)))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, map(chr, cs)))


_TIMESTAMP = re.compile(r"<\|(\d+\.\d+)\|>")


class ByteLevelDecoder:
    """``WhisperTokenizer.decode(ids)`` (default arguments) from the saved
    tokenizer files: ids -> token strings (added tokens first, then
    ``vocab.json``, unknown ids -> ""), runs of vocabulary tokens -> bytes
    through the inverse byte map -> UTF-8 with ``errors`` (default
    "replace"), added tokens kept literally, all joined without spaces,
    then timestamp tokens (``<|1.23|>``) removed from the text. The slow
    Whisper tokenizer's ``_decode`` takes ``clean_up_tokenization_spaces``
    and drops it, so no clean-up rule applies here either."""

    def __init__(self, vocab: dict[str, int], added: dict[int, str], *,
                 unk_token: str | None, errors: str = "replace"):
        self.encoder = vocab
        self.decoder = {i: t for t, i in vocab.items()}
        self.added_decoder = dict(added)
        self.added_encoder = {t: i for i, t in added.items()}
        self.unk_token = unk_token
        self.errors = errors
        self.byte_decoder = {c: b for b, c in bytes_to_unicode().items()}

    @classmethod
    def from_dir(cls, model_dir: str | Path) -> "ByteLevelDecoder":
        d = Path(model_dir)
        vocab_path = d / "vocab.json"
        if not vocab_path.exists():
            raise ModelLoadError(f"{d}: missing vocab.json")
        vocab = json.loads(vocab_path.read_text(encoding="utf-8"))
        tcfg = {}
        if (d / "tokenizer_config.json").exists():
            tcfg = json.loads((d / "tokenizer_config.json").read_text(
                encoding="utf-8"))
        added: dict[int, str] = {}
        if (d / "added_tokens.json").exists():
            for tok, i in json.loads((d / "added_tokens.json").read_text(
                    encoding="utf-8")).items():
                added[int(i)] = tok
        for i, entry in (tcfg.get("added_tokens_decoder") or {}).items():
            added[int(i)] = entry["content"]
        unk = tcfg.get("unk_token")
        if unk is None and (d / "special_tokens_map.json").exists():
            unk = json.loads((d / "special_tokens_map.json").read_text(
                encoding="utf-8")).get("unk_token")
        if isinstance(unk, dict):
            unk = unk.get("content")
        return cls(vocab, added, unk_token=unk,
                   errors=tcfg.get("errors", "replace"))

    def convert_tokens_to_ids(self, token: str) -> int | None:
        if token in self.added_encoder:
            return self.added_encoder[token]
        return self.encoder.get(token, self.encoder.get(self.unk_token)
                                if self.unk_token is not None else None)

    def get_added_vocab(self) -> dict[str, int]:
        return dict(self.added_encoder)

    def _bytes_text(self, tokens: list[str]) -> str:
        data = bytearray(self.byte_decoder[c] for c in "".join(tokens))
        return data.decode("utf-8", errors=self.errors)

    def decode(self, ids) -> str:
        parts: list[str] = []
        run: list[str] = []
        for i in ids:
            i = int(i)
            tok = self.added_decoder.get(i)
            if tok is None:
                tok = self.decoder.get(i, "")
            if tok in self.added_encoder:
                if run:
                    parts.append(self._bytes_text(run))
                    run = []
                parts.append(tok)
            else:
                run.append(tok)
        if run:
            parts.append(self._bytes_text(run))
        return _TIMESTAMP.sub("", "".join(parts))


# --------------------------------------------------------------------------
# Weights
# --------------------------------------------------------------------------

_ST_DTYPES = {
    "F64": torch.float64, "F32": torch.float32, "F16": torch.float16,
    "BF16": torch.bfloat16, "I64": torch.int64, "I32": torch.int32,
    "I16": torch.int16, "I8": torch.int8, "U8": torch.uint8,
    "BOOL": torch.bool,
}


def read_safetensors(path: str | Path) -> dict[str, torch.Tensor]:
    """A ``.safetensors`` file -> CPU tensors (little-endian, row-major)."""
    data = Path(path).read_bytes()
    if len(data) < 8:
        raise ModelLoadError(f"{path}: truncated safetensors header")
    n = int.from_bytes(data[:8], "little")
    if 8 + n > len(data):
        raise ModelLoadError(f"{path}: header length {n} past end of file")
    header = json.loads(data[8:8 + n])
    body = memoryview(data)[8 + n:]
    out: dict[str, torch.Tensor] = {}
    for name, meta in header.items():
        if name == "__metadata__":
            continue
        dtype = _ST_DTYPES.get(meta["dtype"])
        if dtype is None:
            raise ModelLoadError(f"{path}: {name}: dtype {meta['dtype']}")
        lo, hi = meta["data_offsets"]
        if not 0 <= lo <= hi <= len(body):
            raise ModelLoadError(f"{path}: {name}: offsets {lo}..{hi}")
        if hi == lo:
            out[name] = torch.empty(meta["shape"], dtype=dtype)
            continue
        raw = torch.frombuffer(bytearray(body[lo:hi]), dtype=torch.uint8)
        out[name] = raw.view(dtype).reshape(meta["shape"])
    return out


def _load_state_dict(model_dir: Path) -> dict[str, torch.Tensor]:
    st = model_dir / "model.safetensors"
    if st.exists():
        return read_safetensors(st)
    pt = model_dir / "pytorch_model.bin"
    if pt.exists():
        return torch.load(str(pt), map_location="cpu", weights_only=True)
    raise ModelLoadError(
        f"{model_dir}: no model.safetensors or pytorch_model.bin")


def convert_state_dict(sd: dict) -> dict[str, torch.Tensor]:
    """HF state dict -> the flat params dict (names preserved, torch
    layouts kept, float32; ``proj_out`` is tied to ``embed_tokens``)."""
    params: dict[str, torch.Tensor] = {}
    for k, v in sd.items():
        if k == "proj_out.weight":
            continue
        if not k.startswith("model."):
            k = "model." + k                # WhisperModel vs ForConditionalGen
        params[k] = torch.as_tensor(v).to(torch.float32)
    return params


# Linear projections _linear() consumes: the only keys quantization may
# touch (embeddings, convs, layer norms and positions stay float32).
_QUANT_KEY = re.compile(
    r"\.(?:q_proj|k_proj|v_proj|out_proj|fc1|fc2)\.weight$")


def _quantize_weight(w: torch.Tensor, mode: str):
    """One (out, in) float32 weight re-encoded: ``bf16`` -> a bfloat16
    tensor; ``int8`` -> :class:`QuantTensor` with scale = max|row| / 127
    and rows rounded half to even, clipped to [-127, 127]."""
    if mode == "bf16":
        return w.to(torch.bfloat16)
    a = w.numpy()
    amax = np.max(np.abs(a), axis=1)
    scale = np.where(amax > 0, amax, 1.0).astype(np.float32) / 127.0
    q = np.clip(np.round(a / scale[:, None]), -127, 127).astype(np.int8)
    return QuantTensor(q=torch.from_numpy(q), scale=torch.from_numpy(scale))


def quantize_params(params: dict, mode: str) -> dict:
    """Re-encode the linear weights of a flat params dict per ``mode``
    (``f32`` returns it unchanged); other entries are shared, not
    copied."""
    mode = (mode or "f32").strip().lower()
    if mode in ("f32", "fp32", "", "none"):
        return params
    if mode not in ("int8", "bf16"):
        raise ModelLoadError(f"unknown VLOG_WHISPER_QUANT mode {mode!r}")
    return {k: _quantize_weight(v, mode)
            if _QUANT_KEY.search(k) and getattr(v, "ndim", 0) == 2 else v
            for k, v in params.items()}


def derive_special_tokens(tokenizer, hf_cfg: dict,
                          gen_cfg: dict | None) -> SpecialTokens:
    gen_cfg = gen_cfg or {}

    def tid(tok: str) -> int | None:
        i = tokenizer.convert_tokens_to_ids(tok)
        unk = tokenizer.convert_tokens_to_ids(tokenizer.unk_token) \
            if tokenizer.unk_token else None
        return None if i is None or i == unk else i

    no_ts = tid("<|notimestamps|>")
    if no_ts is None:
        raise ModelLoadError("tokenizer lacks <|notimestamps|>")
    lang_ids = {}
    for tok, i in tokenizer.get_added_vocab().items():
        if (tok.startswith("<|") and tok.endswith("|>")
                and 2 < len(tok) <= 7 and tok[2:-2].isalpha()
                and tok[2:-2].islower()):
            lang_ids[tok[2:-2]] = i
    return SpecialTokens(
        sot=gen_cfg.get("decoder_start_token_id",
                        hf_cfg.get("decoder_start_token_id")),
        eot=gen_cfg.get("eos_token_id", hf_cfg.get("eos_token_id")),
        transcribe=tid("<|transcribe|>") or no_ts,
        translate=tid("<|translate|>") or no_ts,
        no_timestamps=no_ts,
        timestamp_begin=no_ts + 1,
        no_speech=tid("<|nospeech|>") or tid("<|nocaptions|>"),
        language_ids=lang_ids,
        suppress=tuple(gen_cfg.get("suppress_tokens") or []),
        begin_suppress=tuple(gen_cfg.get("begin_suppress_tokens") or []),
    )


# Process-wide asset cache keyed on (resolved dir, config.json mtime_ns,
# quant mode, device): a swapped-in checkpoint at the same path is picked
# up without a restart, and f32/int8 or CPU/CUDA callers never share a
# model.
_cache: dict[tuple[str, int, str, str], WhisperAssets] = {}  # guarded-by: _cache_lock
_cache_lock = threading.Lock()


def invalidate() -> None:
    """Drop every cached checkpoint (tests swap model dirs in place)."""
    with _cache_lock:
        _cache.clear()


def resolve_quant(quant: str | None = None) -> str:
    """None -> config.WHISPER_QUANT; normalized to int8|bf16|f32."""
    if quant is None:
        from vlog_tpu_torch import config

        quant = config.WHISPER_QUANT
    quant = (quant or "f32").strip().lower()
    if quant in ("", "none", "fp32"):
        quant = "f32"
    if quant not in ("f32", "bf16", "int8"):
        raise ModelLoadError(f"unknown VLOG_WHISPER_QUANT mode {quant!r}")
    return quant


def load_whisper(model_dir: str | Path, quant: str | None = None, *,
                 device: str | torch.device = "cuda") -> WhisperAssets:
    """The checkpoint at ``model_dir`` on ``device`` (memoized)."""
    from vlog_tpu_torch.device import resolve_device, strict_fp32

    dev = resolve_device(device)
    strict_fp32()
    model_dir = Path(model_dir)
    quant = resolve_quant(quant)
    cfg_path = model_dir / "config.json"
    if not cfg_path.exists():
        raise ModelLoadError(f"{model_dir}: missing config.json")
    key = (str(model_dir.resolve()), cfg_path.stat().st_mtime_ns, quant,
           str(dev))
    with _cache_lock:
        cached = _cache.get(key)
    if cached is not None:
        return cached
    assets = _load_whisper_uncached(model_dir, quant, dev)
    with _cache_lock:
        # A concurrent loader may have won the race; keep the first entry
        # so every caller shares one model (device memory matters).
        assets = _cache.setdefault(key, assets)
    return assets


def _load_whisper_uncached(model_dir: Path, quant: str,
                           device: torch.device) -> WhisperAssets:
    hf_cfg = json.loads((model_dir / "config.json").read_text())
    cfg = WhisperConfig.from_hf(hf_cfg)
    tokenizer = ByteLevelDecoder.from_dir(model_dir)
    gen_cfg = None
    gc_path = model_dir / "generation_config.json"
    if gc_path.exists():
        gen_cfg = json.loads(gc_path.read_text())
    tokens = derive_special_tokens(tokenizer, hf_cfg, gen_cfg)
    params = quantize_params(convert_state_dict(_load_state_dict(model_dir)),
                             quant)
    model = WhisperModel(cfg, device=device).load_params(params)
    return WhisperAssets(cfg=cfg, model=model, tokenizer=tokenizer,
                         tokens=tokens, model_name=model_dir.name)
