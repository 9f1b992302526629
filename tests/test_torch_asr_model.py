"""The port's Whisper forward (``vlog_tpu_torch/asr/model.py``) against the
JAX package's on the same seeded weights and inputs, on the CPU.

Weights come from both packages' ``init_random_params`` (the same numpy
draws) at a tiny width. Tolerances (float32 sums in other orders):
encoder states and teacher-forced logits within rtol 1e-4 of the largest
magnitude (f32 and bf16-stored weights) and 2e-4 (int8, whose
dequantized products are larger); the port's incremental step equals
its own teacher forcing within 1e-5.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from vlog_tpu.asr import load as jload
from vlog_tpu.asr import model as jm
from vlog_tpu_torch.asr import load as tload
from vlog_tpu_torch.asr import model as tm

RTOL = {"f32": 1e-4, "bf16": 1e-4, "int8": 2e-4}
STEP_ATOL = 1e-5

CFG = dict(d_model=64, encoder_layers=2, decoder_layers=2,
           encoder_attention_heads=4, decoder_attention_heads=4,
           encoder_ffn_dim=128, decoder_ffn_dim=128, vocab_size=400,
           max_target_positions=48)


@pytest.fixture(scope="module")
def cfgs():
    return jm.WhisperConfig(**CFG), tm.WhisperConfig(**CFG)


@pytest.fixture(scope="module")
def params(cfgs):
    return jm.init_random_params(cfgs[0], seed=11)


def _to_numpy(p: dict) -> dict:
    """The JAX params dict as numpy (QuantTensor -> (q, scale))."""
    return {k: (np.asarray(v.q), np.asarray(v.scale))
            if isinstance(v, jm.QuantTensor) else np.asarray(v)
            for k, v in p.items()}


def _mel(seed: int, b: int = 2) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return rng.uniform(-1.0, 1.5, (b, 80, 3000)).astype(np.float32)


def _close(got, want, rtol):
    want = np.asarray(want)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= rtol * np.abs(want).max()


def test_init_random_params_same_draws(cfgs):
    jp = jm.init_random_params(cfgs[0], seed=4)
    tp = tm.init_random_params(cfgs[1], seed=4)
    assert list(jp) == list(tp)
    for k in jp:
        assert tp[k].dtype == np.float32
        assert np.array_equal(np.asarray(jp[k]), tp[k]), k


def test_params_from_numpy_state_dict_is_the_hf_layout(cfgs, params):
    model = tm.params_from_numpy(_to_numpy(params), cfgs[1], device="cpu")
    sd = model.state_dict()
    assert set(sd) == set(params)
    for k, v in params.items():
        assert np.array_equal(sd[k].numpy(), np.asarray(v)), k
    # an HF checkpoint's state dict loads with load_state_dict
    again = tm.WhisperModel(cfgs[1])
    again.load_state_dict({k: torch.from_numpy(np.array(v))
                           for k, v in params.items()})
    assert all(torch.equal(again.state_dict()[k], sd[k]) for k in sd)


@pytest.mark.parametrize("quant", ["f32", "bf16", "int8"])
def test_encoder_and_logits_match_jax(cfgs, params, quant):
    jcfg, tcfg = cfgs
    jp = jload.quantize_params(params, quant)
    model = tm.params_from_numpy(_to_numpy(jp), tcfg, device="cpu")
    mel = _mel(5)
    enc_j = jm.encode(jp, mel, jcfg)
    enc_t = tm.encode(model, torch.from_numpy(mel))
    _close(enc_t.numpy(), enc_j, RTOL[quant])
    toks = np.random.default_rng(6).integers(0, CFG["vocab_size"], (2, 12))
    lj = jm.decode_logits(jp, toks, enc_j, jcfg)
    lt = tm.decode_logits(model, torch.from_numpy(toks),
                          torch.from_numpy(np.array(enc_j)))
    _close(lt.numpy(), lj, RTOL[quant])


@pytest.mark.parametrize("quant", ["f32", "bf16", "int8"])
def test_port_quantization_equals_jax_params(cfgs, params, quant):
    """The port's ``quantize_params`` on the float32 dict installs the
    weights ``params_from_numpy`` installs from the JAX package's
    quantized dict, byte for byte."""
    tcfg = cfgs[1]
    want = tm.params_from_numpy(_to_numpy(jload.quantize_params(params, quant)),
                                tcfg, device="cpu").state_dict()
    f32 = tload.convert_state_dict({k: torch.from_numpy(np.array(v))
                                    for k, v in params.items()})
    got = tm.WhisperModel(tcfg).load_params(
        tload.quantize_params(f32, quant)).state_dict()
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and torch.equal(got[k], want[k]), k


def test_incremental_step_equals_teacher_forcing(cfgs, params):
    tcfg = cfgs[1]
    model = tm.params_from_numpy(_to_numpy(params), tcfg, device="cpu")
    enc = tm.encode(model, torch.from_numpy(_mel(8)))
    toks = torch.from_numpy(
        np.random.default_rng(9).integers(0, CFG["vocab_size"], (2, 10)))
    full = tm.decode_logits(model, toks, enc)
    ckv = tm.cross_kv(model, enc)
    cache = tm.DecoderCache.create(tcfg, 2, 16, "cpu")
    for i in range(toks.shape[1]):
        step = tm.decoder_step(model, toks[:, i], i, cache, ckv)
        assert (step - full[:, i]).abs().max() <= STEP_ATOL


def test_forward_runs_in_inference_mode_on_any_thread(cfgs, params):
    """Grad mode is thread-local; the forwards enter inference mode
    themselves, so a decode on another thread builds no graph."""
    import threading

    model = tm.params_from_numpy(_to_numpy(params), cfgs[1], device="cpu")
    out = {}

    def run():
        with torch.enable_grad():
            out["enc"] = tm.encode(model, torch.from_numpy(_mel(2, b=1)))

    t = threading.Thread(target=run)
    t.start()
    t.join()
    assert out["enc"].grad_fn is None and out["enc"].is_inference()
