"""TorchBackend(device="cpu") against JaxBackend with rate control on
(setup and tolerance as in tests/test_torch_backend.py): the host
controllers, their lagged feedback schedule and the device in-chain
adaptation must plan the same QPs, so the CMAF trees stay
byte-identical (the JAX rate-control journal excepted).
"""

from __future__ import annotations

from tests.test_torch_backend import assert_trees_identical, run_both


def test_cmaf_tree_byte_identical_with_rate_control(tmp_path, monkeypatch):
    jres, tres = run_both(tmp_path, monkeypatch, bitrate=150_000)
    assert_trees_identical(tmp_path)
    for j, t in zip(jres.rungs, tres.rungs):
        assert t.target_bitrate == j.target_bitrate > 0
        assert t.achieved_bitrate == j.achieved_bitrate
