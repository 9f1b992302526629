"""Whisper encoder-decoder forward passes in PyTorch.

:class:`WhisperModel` holds the weights under the HuggingFace names the
JAX package's flat params dict uses (``model.encoder.conv1.weight``,
``model.decoder.layers.3.fc1.bias``, ...), so ``state_dict()`` has those
keys and a converted HF checkpoint loads with ``load_state_dict``. The
forward functions keep the JAX names and operation order of
``vlog_tpu/asr/model.py``: ``encode``, ``cross_kv``, ``decode_logits``,
``DecoderCache`` + ``decoder_step`` (the static ``max_len`` cache, every
position attended under the ``arange(max_len) <= pos`` mask), and
``init_random_params`` (the same numpy draws in the same order).

Numerics follow the reference: linears are ``x @ w.T`` then ``+ b``;
layer norm uses the population variance and eps 1e-5; GELU is the erf
form; attention is two matmuls around a softmax whose masked scores are
``finfo(float32).min`` (no fused attention kernel: its sum order and
masking differ). Every forward enters ``torch.inference_mode()`` itself:
the engine decodes on its own thread, where a caller's grad mode does not
reach.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn


@dataclass(frozen=True)
class WhisperConfig:
    """The subset of HF WhisperConfig the forward pass needs."""

    d_model: int
    encoder_layers: int
    decoder_layers: int
    encoder_attention_heads: int
    decoder_attention_heads: int
    encoder_ffn_dim: int
    decoder_ffn_dim: int
    vocab_size: int
    num_mel_bins: int = 80
    max_source_positions: int = 1500
    max_target_positions: int = 448

    @classmethod
    def from_hf(cls, cfg: dict) -> "WhisperConfig":
        return cls(**{f: cfg[f] for f in (
            "d_model", "encoder_layers", "decoder_layers",
            "encoder_attention_heads", "decoder_attention_heads",
            "encoder_ffn_dim", "decoder_ffn_dim", "vocab_size",
            "num_mel_bins", "max_source_positions", "max_target_positions",
        )})


@dataclass(frozen=True)
class QuantTensor:
    """int8 per-output-channel weight: ``w ~ q * scale[:, None]``;
    ``q`` (out, in) int8, ``scale`` (out,) float32."""

    q: torch.Tensor
    scale: torch.Tensor


def _frozen(t: torch.Tensor) -> nn.Parameter:
    return nn.Parameter(t, requires_grad=False)


class Linear(nn.Module):
    """HF Linear, weight (out, in). The weight is float32, bfloat16 (cast
    at use), or int8 ``weight_q`` with a float32 ``weight_scale``
    (dequantized at use), as ``asr/load.py::quantize_params`` gives it."""

    def __init__(self, d_in: int, d_out: int, bias: bool = True):
        super().__init__()
        self.weight = _frozen(torch.empty(d_out, d_in))
        self.bias = _frozen(torch.empty(d_out)) if bias else None
        self.register_buffer("weight_q", None)
        self.register_buffer("weight_scale", None)

    def set_weight(self, w, device: torch.device) -> None:
        """Install a float32/bfloat16 tensor or a :class:`QuantTensor`."""
        if isinstance(w, QuantTensor):
            self.weight = None
            self.weight_q = w.q.to(device)
            self.weight_scale = w.scale.to(device)
        else:
            self.weight_q = self.weight_scale = None
            self.weight = _frozen(w.to(device))


def _linear(lin: Linear, x: torch.Tensor) -> torch.Tensor:
    """``x @ w.T`` (+ b): int8 as ``(x @ q.T.float()) * scale``, bf16 cast
    to the activation dtype at use."""
    if lin.weight_q is not None:
        y = (x @ lin.weight_q.T.to(torch.float32)) * lin.weight_scale
    else:
        w = lin.weight
        if w.dtype != x.dtype:
            w = w.to(x.dtype)
        y = x @ w.T
    return y + lin.bias if lin.bias is not None else y


class LayerNorm(nn.Module):
    def __init__(self, d: int):
        super().__init__()
        self.weight = _frozen(torch.empty(d))
        self.bias = _frozen(torch.empty(d))


def _layer_norm(ln: LayerNorm, x: torch.Tensor) -> torch.Tensor:
    mu = torch.mean(x, dim=-1, keepdim=True)
    var = torch.var(x, dim=-1, keepdim=True, unbiased=False)
    xn = (x - mu) * torch.rsqrt(var + 1e-5)
    return xn * ln.weight + ln.bias


class Embedding(nn.Module):
    def __init__(self, n: int, d: int):
        super().__init__()
        self.weight = _frozen(torch.empty(n, d))


class Conv1d(nn.Module):
    def __init__(self, c_in: int, c_out: int, k: int = 3):
        super().__init__()
        self.weight = _frozen(torch.empty(c_out, c_in, k))
        self.bias = _frozen(torch.empty(c_out))


class Attention(nn.Module):
    def __init__(self, d: int):
        super().__init__()
        self.q_proj = Linear(d, d)
        self.k_proj = Linear(d, d, bias=False)   # k_proj has no bias in HF
        self.v_proj = Linear(d, d)
        self.out_proj = Linear(d, d)


class Layer(nn.Module):
    def __init__(self, d: int, ffn: int, cross: bool):
        super().__init__()
        self.self_attn = Attention(d)
        self.self_attn_layer_norm = LayerNorm(d)
        if cross:
            self.encoder_attn = Attention(d)
            self.encoder_attn_layer_norm = LayerNorm(d)
        self.fc1 = Linear(d, ffn)
        self.fc2 = Linear(ffn, d)
        self.final_layer_norm = LayerNorm(d)


class Encoder(nn.Module):
    def __init__(self, cfg: WhisperConfig):
        super().__init__()
        d = cfg.d_model
        self.conv1 = Conv1d(cfg.num_mel_bins, d)
        self.conv2 = Conv1d(d, d)
        self.embed_positions = Embedding(cfg.max_source_positions, d)
        self.layers = nn.ModuleList(
            Layer(d, cfg.encoder_ffn_dim, cross=False)
            for _ in range(cfg.encoder_layers))
        self.layer_norm = LayerNorm(d)


class Decoder(nn.Module):
    def __init__(self, cfg: WhisperConfig):
        super().__init__()
        d = cfg.d_model
        self.embed_tokens = Embedding(cfg.vocab_size, d)
        self.embed_positions = Embedding(cfg.max_target_positions, d)
        self.layers = nn.ModuleList(
            Layer(d, cfg.decoder_ffn_dim, cross=True)
            for _ in range(cfg.decoder_layers))
        self.layer_norm = LayerNorm(d)


class _Body(nn.Module):
    def __init__(self, cfg: WhisperConfig):
        super().__init__()
        self.encoder = Encoder(cfg)
        self.decoder = Decoder(cfg)


class WhisperModel(nn.Module):
    """The weights, under the HF names (``model.`` prefix included)."""

    def __init__(self, cfg: WhisperConfig,
                 device: str | torch.device = "cpu"):
        super().__init__()
        with torch.device(device):
            self.model = _Body(cfg)
        self.cfg = cfg

    @property
    def device(self) -> torch.device:
        return self.model.decoder.embed_tokens.weight.device

    def load_params(self, params: dict) -> "WhisperModel":
        """Install a flat ``{hf_name: tensor | QuantTensor}`` dict (the JAX
        package's params layout, ``proj_out`` already dropped); every
        name must exist and every weight must be set."""
        linears = {name: mod for name, mod in self.named_modules()
                   if isinstance(mod, Linear)}
        tensors = dict(self.named_parameters())
        seen = set()
        for key, value in params.items():
            owner = key.rsplit(".", 1)[0]
            if key.endswith(".weight") and owner in linears:
                linears[owner].set_weight(value, self.device)
            elif key in tensors:
                tensors[key].data = value.to(self.device, torch.float32)
            else:
                raise KeyError(f"unexpected Whisper parameter {key!r}")
            seen.add(key)
        missing = {k for k, _ in self.named_parameters()} - seen
        missing |= {f"{n}.weight" for n in linears} - seen
        if missing:
            raise KeyError(f"missing Whisper parameters: {sorted(missing)[:5]}")
        return self


def params_from_numpy(params: dict, cfg: WhisperConfig, *,
                      device: str | torch.device = "cuda") -> WhisperModel:
    """The JAX package's params dict as numpy arrays (each int8
    ``QuantTensor`` given as its ``(q, scale)`` pair; bfloat16 weights
    as numpy bfloat16 arrays) -> the port's model on ``device``."""
    from vlog_tpu_torch.device import resolve_device

    dev = resolve_device(device)
    conv = {}
    for k, v in params.items():
        if isinstance(v, tuple):
            conv[k] = QuantTensor(q=torch.from_numpy(np.array(v[0], np.int8)),
                                  scale=torch.from_numpy(
                                      np.array(v[1], np.float32)))
        elif np.asarray(v).dtype.name == "bfloat16":
            bits = np.ascontiguousarray(np.asarray(v)).view(np.uint16)
            conv[k] = torch.from_numpy(bits.astype(np.int16)).view(
                torch.bfloat16)
        else:
            conv[k] = torch.from_numpy(np.array(v, np.float32))
    return WhisperModel(cfg, device=dev).load_params(conv)


def _split_heads(x: torch.Tensor, n_heads: int) -> torch.Tensor:
    b, t, d = x.shape
    return x.reshape(b, t, n_heads, d // n_heads).transpose(1, 2)


def _merge_heads(x: torch.Tensor) -> torch.Tensor:
    b, h, t, hd = x.shape
    return x.transpose(1, 2).reshape(b, t, h * hd)


def _attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               mask: torch.Tensor | None) -> torch.Tensor:
    """(B,H,Tq,hd) x (B,H,Tk,hd); q pre-scaled (HF convention)."""
    scores = q @ k.transpose(-1, -2)
    if mask is not None:
        scores = torch.where(mask, scores, torch.finfo(scores.dtype).min)
    return torch.softmax(scores, dim=-1) @ v


def _self_attn(att: Attention, x: torch.Tensor, n_heads: int,
               mask: torch.Tensor | None) -> torch.Tensor:
    head_dim = x.shape[-1] // n_heads
    q = _linear(att.q_proj, x) * head_dim ** -0.5
    k = _linear(att.k_proj, x)
    v = _linear(att.v_proj, x)
    out = _attention(_split_heads(q, n_heads), _split_heads(k, n_heads),
                     _split_heads(v, n_heads), mask)
    return _linear(att.out_proj, _merge_heads(out))


def _conv1d(conv: Conv1d, x: torch.Tensor, stride: int) -> torch.Tensor:
    """x: (B, C_in, T); HF Conv1d weight (C_out, C_in, K), pad 1."""
    y = F.conv1d(x, conv.weight, stride=stride, padding=1)
    return y + conv.bias[None, :, None]


def _ffn(layer: Layer, x: torch.Tensor) -> torch.Tensor:
    h = _layer_norm(layer.final_layer_norm, x)
    h = F.gelu(_linear(layer.fc1, h))
    return x + _linear(layer.fc2, h)


# --------------------------------------------------------------------------
# Encoder
# --------------------------------------------------------------------------

@torch.inference_mode()
def encode(model: WhisperModel, mel: torch.Tensor) -> torch.Tensor:
    """(B, n_mels, 3000) log-mel -> (B, 1500, d) encoder states."""
    cfg, enc = model.cfg, model.model.encoder
    x = F.gelu(_conv1d(enc.conv1, mel, 1))
    x = F.gelu(_conv1d(enc.conv2, x, 2))
    x = x.transpose(1, 2)                                  # (B, T, d)
    x = x + enc.embed_positions.weight[: x.shape[1]]
    for layer in enc.layers:
        h = _layer_norm(layer.self_attn_layer_norm, x)
        x = x + _self_attn(layer.self_attn, h, cfg.encoder_attention_heads,
                           None)
        x = _ffn(layer, x)
    return _layer_norm(enc.layer_norm, x)


# --------------------------------------------------------------------------
# Decoder (teacher-forced)
# --------------------------------------------------------------------------

@torch.inference_mode()
def cross_kv(model: WhisperModel, enc: torch.Tensor
             ) -> list[tuple[torch.Tensor, torch.Tensor]]:
    """Per-layer cross-attention K/V (contiguous (B, H, T, hd)), computed
    once per audio window."""
    nh = model.cfg.decoder_attention_heads
    out = []
    for layer in model.model.decoder.layers:
        att = layer.encoder_attn
        k = _split_heads(_linear(att.k_proj, enc), nh).contiguous()
        v = _split_heads(_linear(att.v_proj, enc), nh).contiguous()
        out.append((k, v))
    return out


def _cross_attn(att: Attention, x: torch.Tensor, kv, n_heads: int
                ) -> torch.Tensor:
    head_dim = x.shape[-1] // n_heads
    q = _linear(att.q_proj, x) * head_dim ** -0.5
    out = _attention(_split_heads(q, n_heads), kv[0], kv[1], None)
    return _linear(att.out_proj, _merge_heads(out))


@torch.inference_mode()
def decode_logits(model: WhisperModel, tokens: torch.Tensor,
                  enc: torch.Tensor) -> torch.Tensor:
    """Teacher-forced full-sequence decoder: (B, L) tokens -> (B, L, V)."""
    cfg, dec = model.cfg, model.model.decoder
    L = tokens.shape[1]
    x = dec.embed_tokens.weight[tokens] + dec.embed_positions.weight[:L]
    causal = torch.tril(torch.ones((L, L), dtype=torch.bool,
                                   device=x.device))[None, None]
    ckv = cross_kv(model, enc)
    nh = cfg.decoder_attention_heads
    for layer, kv in zip(dec.layers, ckv):
        h = _layer_norm(layer.self_attn_layer_norm, x)
        x = x + _self_attn(layer.self_attn, h, nh, causal)
        h = _layer_norm(layer.encoder_attn_layer_norm, x)
        x = x + _cross_attn(layer.encoder_attn, h, kv, nh)
        x = _ffn(layer, x)
    x = _layer_norm(dec.layer_norm, x)
    return x @ dec.embed_tokens.weight.T


# --------------------------------------------------------------------------
# Incremental decoder step with a static-shape KV cache
# --------------------------------------------------------------------------

@dataclass
class DecoderCache:
    """Preallocated self-attention K/V: (layers, B, H, max_len, hd)."""

    k: torch.Tensor
    v: torch.Tensor

    @classmethod
    def create(cls, cfg: WhisperConfig, batch: int, max_len: int,
               device: str | torch.device = "cuda",
               dtype=torch.float32) -> "DecoderCache":
        hd = cfg.d_model // cfg.decoder_attention_heads
        shape = (cfg.decoder_layers, batch, cfg.decoder_attention_heads,
                 max_len, hd)
        with torch.inference_mode():
            return cls(k=torch.zeros(shape, dtype=dtype, device=device),
                       v=torch.zeros(shape, dtype=dtype, device=device))


@torch.inference_mode()
def decoder_step(model: WhisperModel, tokens: torch.Tensor, pos: int,
                 cache: DecoderCache, ckv) -> torch.Tensor:
    """One decode step: (B,) tokens at position ``pos`` -> (B, V) logits.

    Writes this position's K/V into ``cache`` in place and attends over
    the whole ``max_len`` cache with positions > ``pos`` masked.
    """
    cfg, dec = model.cfg, model.model.decoder
    nh = cfg.decoder_attention_heads
    hd = cfg.d_model // nh
    max_len = cache.k.shape[3]
    x = (dec.embed_tokens.weight[tokens]
         + dec.embed_positions.weight[pos])[:, None, :]
    mask = (torch.arange(max_len, device=x.device) <= pos)[None, None, None, :]
    for i, layer in enumerate(dec.layers):
        att = layer.self_attn
        h = _layer_norm(layer.self_attn_layer_norm, x)
        q = _linear(att.q_proj, h) * hd ** -0.5
        cache.k[i, :, :, pos] = _split_heads(_linear(att.k_proj, h), nh)[:, :, 0]
        cache.v[i, :, :, pos] = _split_heads(_linear(att.v_proj, h), nh)[:, :, 0]
        out = _attention(_split_heads(q, nh), cache.k[i], cache.v[i], mask)
        x = x + _linear(att.out_proj, _merge_heads(out))
        h = _layer_norm(layer.encoder_attn_layer_norm, x)
        x = x + _cross_attn(layer.encoder_attn, h, ckv[i], nh)
        x = _ffn(layer, x)
    x = _layer_norm(dec.layer_norm, x)
    return (x @ dec.embed_tokens.weight.T)[:, 0, :]


def init_random_params(cfg: WhisperConfig, seed: int = 0
                       ) -> dict[str, np.ndarray]:
    """Random params in the HF naming scheme: the JAX package's numpy
    draws, in the same order (tests, the smoke's checkpoint)."""
    rng = np.random.default_rng(seed)
    p: dict[str, np.ndarray] = {}

    def w(name, *shape, scale=0.02):
        p[name] = (rng.standard_normal(shape) * scale).astype(np.float32)

    def ln(name):
        p[f"{name}.weight"] = np.ones(cfg.d_model, np.float32)
        p[f"{name}.bias"] = np.zeros(cfg.d_model, np.float32)

    d = cfg.d_model
    w("model.encoder.conv1.weight", d, cfg.num_mel_bins, 3)
    w("model.encoder.conv1.bias", d)
    w("model.encoder.conv2.weight", d, d, 3)
    w("model.encoder.conv2.bias", d)
    w("model.encoder.embed_positions.weight", cfg.max_source_positions, d)
    w("model.decoder.embed_tokens.weight", cfg.vocab_size, d)
    w("model.decoder.embed_positions.weight", cfg.max_target_positions, d)
    ln("model.encoder.layer_norm")
    ln("model.decoder.layer_norm")
    for side, nl, ffn in (("encoder", cfg.encoder_layers, cfg.encoder_ffn_dim),
                          ("decoder", cfg.decoder_layers, cfg.decoder_ffn_dim)):
        for i in range(nl):
            n = f"model.{side}.layers.{i}"
            attns = ["self_attn"] if side == "encoder" else [
                "self_attn", "encoder_attn"]
            for a in attns:
                w(f"{n}.{a}.q_proj.weight", d, d)
                w(f"{n}.{a}.q_proj.bias", d)
                w(f"{n}.{a}.k_proj.weight", d, d)
                w(f"{n}.{a}.v_proj.weight", d, d)
                w(f"{n}.{a}.v_proj.bias", d)
                w(f"{n}.{a}.out_proj.weight", d, d)
                w(f"{n}.{a}.out_proj.bias", d)
                ln(f"{n}.{a}_layer_norm")
            w(f"{n}.fc1.weight", ffn, d)
            w(f"{n}.fc1.bias", ffn)
            w(f"{n}.fc2.weight", d, ffn)
            w(f"{n}.fc2.bias", d)
            ln(f"{n}.final_layer_norm")
    return p
