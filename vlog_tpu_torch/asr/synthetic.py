"""A random-weight Whisper checkpoint directory at given widths.

No published weights ship with the repository, so the card runs Whisper
at a published configuration's widths (``WHISPER_SMALL`` is
``openai/whisper-small``'s ``config.json``) with seeded random weights
(``init_random_params``) and a synthetic byte-level vocabulary whose
special tokens sit at whisper-small's ids: ``<|endoftext|>`` 50257,
``<|startoftranscript|>`` 50258, the 99 languages from 50259,
``<|translate|>`` 50358, ``<|transcribe|>`` 50359, ``<|startoflm|>``
50360, ``<|startofprev|>`` 50361, ``<|nocaptions|>`` 50362,
``<|notimestamps|>`` 50363 and the timestamps from 50364. The directory
has the files ``load_whisper`` reads (``config.json``,
``generation_config.json``, ``pytorch_model.bin``, ``vocab.json``,
``merges.txt``, ``tokenizer_config.json``, ``added_tokens.json``).
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np
import torch

from vlog_tpu_torch.asr.load import bytes_to_unicode
from vlog_tpu_torch.asr.model import WhisperConfig, init_random_params

WHISPER_SMALL = WhisperConfig(
    d_model=768, encoder_layers=12, decoder_layers=12,
    encoder_attention_heads=12, decoder_attention_heads=12,
    encoder_ffn_dim=3072, decoder_ffn_dim=3072, vocab_size=51865,
    num_mel_bins=80, max_source_positions=1500, max_target_positions=448)

# Whisper's language tokens in id order (multilingual v1/v2 checkpoints).
LANGUAGES = (
    "en zh de es ru ko fr ja pt tr pl ca nl ar sv it id hi fi vi he uk el "
    "ms cs ro da hu ta no th ur hr bg lt la mi ml cy sk te fa lv bn sr az "
    "sl kn et mk br eu is hy ne mn bs kk sq sw gl mr pa si km sn yo so af "
    "oc ka be tg sd gu am yi lo uz fo ht ps tk nn mt sa lb my bo tl mg as "
    "tt haw ln ha ba jw su").split()

TEXT_VOCAB = 50257          # vocab.json entries (ids 0..50256)


def special_tokens(n_timestamps: int = 1501) -> list[str]:
    """The added tokens in id order from ``TEXT_VOCAB``."""
    return (["<|endoftext|>", "<|startoftranscript|>"]
            + [f"<|{lang}|>" for lang in LANGUAGES]
            + ["<|translate|>", "<|transcribe|>", "<|startoflm|>",
               "<|startofprev|>", "<|nocaptions|>", "<|notimestamps|>"]
            + [f"<|{0.02 * i:.2f}|>" for i in range(n_timestamps)])


def synthetic_vocab(seed: int = 0) -> dict[str, int]:
    """``TEXT_VOCAB`` byte-level tokens: the 256 single bytes, then
    distinct strings of 2-6 bytes (a leading space on about a third),
    drawn from ``seed``."""
    chars = bytes_to_unicode()
    vocab = {chars[b]: i for i, b in enumerate(sorted(chars))}
    rng = np.random.default_rng(seed)
    letters = [chars[b] for b in b"abcdefghijklmnopqrstuvwxyz'"]
    space = chars[ord(" ")]
    while len(vocab) < TEXT_VOCAB:
        n = int(rng.integers(2, 7))
        tok = "".join(letters[i] for i in rng.integers(0, len(letters), n))
        if rng.random() < 0.33:
            tok = space + tok[1:]
        vocab.setdefault(tok, len(vocab))
    return vocab


def write_checkpoint(model_dir: str | Path, cfg: WhisperConfig = WHISPER_SMALL,
                     *, seed: int = 0) -> Path:
    """Write the checkpoint directory (weights from ``seed``)."""
    d = Path(model_dir)
    d.mkdir(parents=True, exist_ok=True)
    vocab = synthetic_vocab(seed)
    n_ts = cfg.vocab_size - TEXT_VOCAB - 6 - 2 - len(LANGUAGES)
    if n_ts < 1:
        raise ValueError(f"vocab_size {cfg.vocab_size} leaves no timestamps")
    added = {TEXT_VOCAB + i: t for i, t in enumerate(special_tokens(n_ts))}
    ids = {t: i for i, t in added.items()}
    (d / "vocab.json").write_text(json.dumps(vocab, ensure_ascii=False),
                                  encoding="utf-8")
    (d / "merges.txt").write_text("#version: 0.2\n")
    (d / "added_tokens.json").write_text(json.dumps(ids))
    (d / "tokenizer_config.json").write_text(json.dumps({
        "tokenizer_class": "WhisperTokenizer", "errors": "replace",
        "unk_token": "<|endoftext|>", "bos_token": "<|endoftext|>",
        "eos_token": "<|endoftext|>", "clean_up_tokenization_spaces": True,
        "added_tokens_decoder": {
            str(i): {"content": t, "special": True}
            for i, t in added.items()}}))
    hf = {f: getattr(cfg, f) for f in cfg.__dataclass_fields__}
    hf.update(model_type="whisper",
              decoder_start_token_id=ids["<|startoftranscript|>"],
              eos_token_id=ids["<|endoftext|>"],
              bos_token_id=ids["<|endoftext|>"],
              pad_token_id=ids["<|endoftext|>"])
    (d / "config.json").write_text(json.dumps(hf, indent=1))
    (d / "generation_config.json").write_text(json.dumps({
        "decoder_start_token_id": ids["<|startoftranscript|>"],
        "eos_token_id": ids["<|endoftext|>"],
        "begin_suppress_tokens": [220, ids["<|endoftext|>"]],
        "suppress_tokens": []}))
    params = init_random_params(cfg, seed)
    torch.save({k: torch.from_numpy(v) for k, v in params.items()},
               d / "pytorch_model.bin")
    return d
