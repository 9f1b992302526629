"""A whole run at CPU sizes (the look for a card skipped), with the timed
path broken underneath: ``correct`` comes out false for each fault a
cell can have, and true with none."""

import contextlib
import inspect

import pytest
import torch

from benchmark import run as brun


def _run(root, cell, seconds):
    torch.set_num_threads(2)
    args = brun.parse_args(["--workload", cell, "--seed", "2147483905",
                            "--seconds", str(seconds), "--trace", "0"])
    result, checks = brun.run(args, device="cpu", root=root)
    return result, {c.name: c.value for c in checks}


def _alter_level(monkeypatch):
    from vlog_tpu_torch.parallel import hevc_ladder

    orig = hevc_ladder.encode_chain_dsp

    def broken(*a, **kw):
        out = orig(*a, **kw)
        out[0][0][0][:, 0, 0, 0, 0] += 1        # one intra level a chain
        return out

    monkeypatch.setattr(hevc_ladder, "encode_chain_dsp", broken)


def _alter_resize(monkeypatch):
    from vlog_tpu_torch.parallel import hevc_ladder

    orig = hevc_ladder.resize_yuv420

    def broken(y, u, v, mats):
        ry, ru, rv = orig(y, u, v, mats)
        return torch.roll(ry, 1, dims=-1), ru, rv

    monkeypatch.setattr(hevc_ladder, "resize_yuv420", broken)


def _half_chains(monkeypatch):
    # half of each chain's frames left out: the second half repeats the
    # first half's planes
    from vlog_tpu_torch.parallel import hevc_ladder

    orig = hevc_ladder.encode_chain_dsp

    def broken(y, u, v, *a, **kw):
        h = y.shape[1] // 2
        rep = lambda p: torch.cat([p[:, :h], p[:, :p.shape[1] - h]], 1)  # noqa: E731
        return orig(rep(y), rep(u), rep(v), *a, **kw)

    monkeypatch.setattr(hevc_ladder, "encode_chain_dsp", broken)


def _drop_sample(monkeypatch):
    from vlog_tpu_torch.backends import hevc_path

    orig = hevc_path.media_segment
    monkeypatch.setattr(hevc_path, "media_segment",
                        lambda track, seq, base, chunk: orig(track, seq, base,
                                                             chunk[:-1]))


def _ladder_control(monkeypatch):
    from benchmark.drivers import ladder

    return ladder.control()


@pytest.mark.parametrize("fault,number", [
    (None, None), (_alter_level, "dsp_mismatch"),
    (_alter_resize, "resize_mae"), (_half_chains, "dsp_mismatch"),
    (_drop_sample, "tree_faults"), (_ladder_control, "resize_mae")])
def test_ladder_run_judges(tiny_root, monkeypatch, fault, number):
    with contextlib.ExitStack() as stack:
        planted = fault(monkeypatch) if fault is not None else None
        if planted is not None:
            stack.enter_context(planted)
        result, values = _run(tiny_root, "hevc-ladder.1080p-clips", 8)
    assert result["correct"] is (fault is None), values
    if number:
        assert values[number] > 0


def _alter_token(monkeypatch):
    from vlog_tpu_torch.asr import decode

    orig = decode.generate_batch

    def broken(*a, **kw):
        toks, nsp = orig(*a, **kw)
        toks = toks.copy()
        toks[:, 1] = 4000                       # a text token, off its beam
        return toks, nsp

    monkeypatch.setattr(decode, "generate_batch", broken)


def _half_batch(monkeypatch):
    # half of each batch left out: its rows come back undecoded (the
    # token buffer's end-of-text fill)
    from vlog_tpu_torch.asr import engine

    orig = engine.generate_rows

    def broken(assets, feats, devices, **kw):
        toks, nsp = orig(assets, feats, devices, **kw)
        toks = toks.copy()
        toks[toks.shape[0] // 2:] = assets.tokens.eot
        return toks, nsp

    monkeypatch.setattr(engine, "generate_rows", broken)


def _wrong_children(monkeypatch):
    # every step keeps the continuations ranked 2 to beam + 1
    from vlog_tpu_torch.asr import decode

    def shifted(x, k):
        vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
        return vals[..., 1:k + 1], idx[..., 1:k + 1]

    monkeypatch.setattr(decode, "top_k_lower_index_first", shifted)


def _worst_final(monkeypatch):
    # the last of the final beams, the lowest scored, is served (the
    # beams come sorted by score; argmin would not do: unfinished beams'
    # handicap of 1e9 absorbs their differences in float32)
    from vlog_tpu_torch.asr import decode

    src = inspect.getsource(decode._generate_beam)
    pick = "torch.argmax(norm.reshape(b, k), dim=1)"
    assert pick in src
    made = {}
    exec(compile(src.replace(pick, "torch.full((b,), k - 1, device=dev)"),
                 decode.__file__, "exec"), decode.__dict__, made)
    monkeypatch.setattr(decode, "_generate_beam", made["_generate_beam"])


@pytest.mark.parametrize("fault,number", [
    (None, None), (_alter_token, "served_faults"),
    (_half_batch, "served_faults"), (_wrong_children, "beam_margin"),
    (_worst_final, "beam_margin")])
def test_captions_run_judges(tiny_root, monkeypatch, fault, number):
    if fault is not None:
        fault(monkeypatch)
    result, values = _run(tiny_root, "whisper-small.backlog", 10)
    assert result["correct"] is (fault is None), values
    if number:
        assert values[number] > 0
