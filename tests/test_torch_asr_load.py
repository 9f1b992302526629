"""Checkpoint loading in the port (``vlog_tpu_torch/asr/load.py``) without
``transformers``: the byte-level decoder against
``transformers.WhisperTokenizer.decode``, special tokens and int8
quantization against the JAX package's loader, the safetensors and
``.bin`` readers, and the synthetic whisper-small checkpoint's tokenizer
files. Everything here is compared for equality (strings, ids, bytes).
"""

from __future__ import annotations

import json
import struct

import numpy as np
import pytest
import torch

transformers = pytest.importorskip("transformers")

from vlog_tpu.asr import load as jload
from vlog_tpu_torch.asr import load as tload
from vlog_tpu_torch.asr import synthetic


@pytest.fixture(scope="module")
def hf_tok(tiny_model_dir):
    return transformers.WhisperTokenizer.from_pretrained(str(tiny_model_dir))


def _random_ids(rng, n_vocab: int, n_added: int, k: int) -> list[list[int]]:
    """Random id runs: valid and invalid UTF-8 byte runs, added tokens,
    unknown ids, and the clean-up patterns (" .", " n't", " 's", ...)."""
    byte_id = {b: i for i, b in enumerate(sorted(tload.bytes_to_unicode()))}
    patterns = [" .", " ?", " !", " ,", " ' ", " n't", " 'm", " 's", " 've",
                " 're", "héllo wörld", "日本語", "<|1.00|>", "<|0.20|>x"]
    out = []
    for _ in range(k):
        ids = []
        for _ in range(int(rng.integers(1, 12))):
            kind = rng.integers(0, 5)
            if kind == 0:
                text = patterns[int(rng.integers(0, len(patterns)))]
                ids += [byte_id[b] for b in text.encode("utf-8")]
            elif kind == 1:
                ids += [byte_id[int(b)] for b in rng.integers(0x80, 0x100, 3)]
            elif kind == 2:
                ids.append(int(rng.integers(n_vocab, n_vocab + n_added)))
            elif kind == 3:
                ids.append(int(rng.integers(n_vocab + n_added,
                                            n_vocab + n_added + 50)))
            else:
                ids += [int(i) for i in rng.integers(0, n_vocab, 4)]
        out.append(ids)
    return out


def test_decode_equals_transformers(tiny_model_dir, hf_tok):
    dec = tload.ByteLevelDecoder.from_dir(tiny_model_dir)
    rng = np.random.default_rng(0)
    seqs = _random_ids(rng, 256, len(hf_tok.get_added_vocab()), 400)
    for ids in seqs:
        assert dec.decode(ids) == hf_tok.decode(ids), ids


def test_decode_equals_transformers_on_the_synthetic_vocab(tmp_path):
    """The synthetic whisper-small tokenizer files: the same decode, the
    same special-token ids, and the flag ``clean_up_tokenization_spaces``
    set (WhisperTokenizer does not apply it; neither does the port)."""
    cfg = synthetic.WHISPER_SMALL
    d = tmp_path / "ckpt"
    d.mkdir()
    vocab = synthetic.synthetic_vocab(3)
    assert len(vocab) == synthetic.TEXT_VOCAB == len(set(vocab))
    (d / "vocab.json").write_text(json.dumps(vocab, ensure_ascii=False),
                                  encoding="utf-8")
    (d / "merges.txt").write_text("#version: 0.2\n")
    specials = synthetic.special_tokens(cfg.vocab_size - 50257 - 107)
    added = {50257 + i: t for i, t in enumerate(specials)}
    assert len(specials) == 1608 and added[50363] == "<|notimestamps|>"
    assert added[50364] == "<|0.00|>" and added[51864] == "<|30.00|>"
    (d / "added_tokens.json").write_text(json.dumps(
        {t: i for i, t in added.items()}))
    (d / "tokenizer_config.json").write_text(json.dumps({
        "tokenizer_class": "WhisperTokenizer", "unk_token": "<|endoftext|>",
        "bos_token": "<|endoftext|>", "eos_token": "<|endoftext|>",
        "clean_up_tokenization_spaces": True, "added_tokens_decoder": {
            str(i): {"content": t, "special": True}
            for i, t in added.items()}}))
    hf = transformers.WhisperTokenizer.from_pretrained(str(d))
    assert hf.clean_up_tokenization_spaces is True
    dec = tload.ByteLevelDecoder.from_dir(d)
    assert dec.get_added_vocab() == hf.get_added_vocab()
    rng = np.random.default_rng(1)
    for ids in _random_ids(rng, synthetic.TEXT_VOCAB, len(added), 300):
        assert dec.decode(ids) == hf.decode(ids), ids
    hf_cfg = {"decoder_start_token_id": 50258, "eos_token_id": 50257}
    assert vars(tload.derive_special_tokens(dec, hf_cfg, None)) == \
        vars(jload.derive_special_tokens(hf, hf_cfg, None))


def test_whisper_languages_are_transformers_order():
    from transformers.models.whisper.tokenization_whisper import LANGUAGES

    assert tuple(synthetic.LANGUAGES) == tuple(LANGUAGES)[:99]


def test_special_tokens_equal_jax(tiny_model_dir):
    ja = jload.load_whisper(tiny_model_dir)
    ta = tload.load_whisper(tiny_model_dir, device="cpu")
    assert vars(ta.tokens) == vars(ja.tokens)
    assert ta.cfg.__dict__ == ja.cfg.__dict__ and ta.model_name == ja.model_name


@pytest.mark.parametrize("mode", ["int8", "bf16"])
def test_quantization_bytes_equal_jax(tiny_model_dir, mode):
    ja = jload.load_whisper(tiny_model_dir, mode)
    ta = tload.load_whisper(tiny_model_dir, mode, device="cpu")
    sd = ta.model.state_dict()
    n = 0
    for k, v in ja.params.items():
        if isinstance(v, jload.QuantTensor):
            q, s = sd[k[:-len("weight")] + "weight_q"], sd[
                k[:-len("weight")] + "weight_scale"]
            assert q.dtype == torch.int8 and s.dtype == torch.float32
            assert q.numpy().tobytes() == np.asarray(v.q).tobytes(), k
            assert s.numpy().tobytes() == np.asarray(v.scale).tobytes(), k
            n += 1
        elif str(v.dtype) == "bfloat16":
            assert sd[k].dtype == torch.bfloat16
            bits = np.asarray(v).view(np.uint16)
            assert np.array_equal(sd[k].view(torch.int16).numpy().view(
                np.uint16), bits), k
            n += 1
        else:
            assert np.array_equal(sd[k].numpy(), np.asarray(v)), k
    assert n == 2 * 6 + 2 * 10     # every projection and FFN weight


def _write_safetensors(path, tensors: dict[str, np.ndarray]) -> None:
    names = {np.dtype(np.float32): "F32", np.dtype(np.float16): "F16",
             np.dtype(np.int8): "I8", np.dtype(np.int64): "I64"}
    header, blobs, off = {"__metadata__": {"format": "pt"}}, [], 0
    for k, v in tensors.items():
        raw = np.ascontiguousarray(v).astype(v.dtype.newbyteorder("<")).tobytes()
        header[k] = {"dtype": names[v.dtype], "shape": list(v.shape),
                     "data_offsets": [off, off + len(raw)]}
        blobs.append(raw)
        off += len(raw)
    h = json.dumps(header).encode()
    path.write_bytes(struct.pack("<Q", len(h)) + h + b"".join(blobs))


def test_safetensors_reader(tmp_path):
    rng = np.random.default_rng(5)
    tensors = {"a.weight": rng.standard_normal((3, 4)).astype(np.float32),
               "b": rng.standard_normal(7).astype(np.float16),
               "c": rng.integers(-128, 127, (2, 2, 2)).astype(np.int8),
               "d": np.arange(3, dtype=np.int64), "e": np.zeros((0, 3), np.float32)}
    _write_safetensors(tmp_path / "m.safetensors", tensors)
    got = tload.read_safetensors(tmp_path / "m.safetensors")
    assert set(got) == set(tensors)
    for k, v in tensors.items():
        assert got[k].numpy().dtype == v.dtype and np.array_equal(got[k].numpy(), v)
    (tmp_path / "bad.safetensors").write_bytes(struct.pack("<Q", 999) + b"{}")
    with pytest.raises(tload.ModelLoadError):
        tload.read_safetensors(tmp_path / "bad.safetensors")


@pytest.mark.parametrize("fmt", ["safetensors", "bin"])
def test_checkpoint_formats_load_the_same_model(tiny_model_dir, tmp_path, fmt):
    """The tiny checkpoint (transformers' own ``model.safetensors``)
    rewritten as the other format loads to the same weights."""
    import shutil

    d = tmp_path / "copy"
    shutil.copytree(tiny_model_dir, d)
    sd = tload._load_state_dict(tiny_model_dir)
    if fmt == "bin":
        (d / "model.safetensors").unlink(missing_ok=True)
        torch.save(sd, d / "pytorch_model.bin")
    else:
        (d / "pytorch_model.bin").unlink(missing_ok=True)
        _write_safetensors(d / "model.safetensors",
                           {k: v.numpy() for k, v in sd.items()})
    got = tload.load_whisper(d, device="cpu").model.state_dict()
    want = tload.load_whisper(tiny_model_dir, device="cpu").model.state_dict()
    assert set(got) == set(want)
    assert all(torch.equal(got[k], want[k]) for k in want)


def test_load_errors(tmp_path):
    with pytest.raises(tload.ModelLoadError):
        tload.load_whisper(tmp_path, device="cpu")
    with pytest.raises(tload.ModelLoadError):
        tload.resolve_quant("int4")
    assert tload.resolve_quant(" FP32 ") == "f32"
