"""The controls on the card, at the cells' widths and a size a test run
holds: the program reads within each limit, the control (one precision
below the configuration's) beyond it.

    python -m pytest benchmark/tests/test_bench_controls.py -q -p no:cacheprovider

(on the card; here they skip). ``benchmark/controls.py`` reads the same
numbers over whole short windows on many seeds.
"""

import json

import pytest
import torch

from benchmark import content
from benchmark import run as brun
from benchmark.reference import resize as ref_resize
from benchmark.spec import ROOT

pytestmark = pytest.mark.cuda


def _config(name):
    return json.loads((ROOT / "benchmark" / "configs" / f"{name}.json").read_text())


def test_whisper_small_control_comes_out_incorrect(cuda):
    # a whole run at the cell's own load (16 windows x beam 5 a tick), a
    # short window: correct as the program is, not with TF32 switched on
    from benchmark.drivers import captions

    args = brun.parse_args(["--workload", "whisper-small.backlog", "--seed",
                            "2147483911", "--seconds", "8"])
    result, checks = brun.run(args)
    assert result["correct"], checks
    with captions.control():
        result, checks = brun.run(args)
    assert not result["correct"], checks


def test_hevc_ladder_resize_control_reads_beyond_the_limit(cuda):
    from vlog_tpu_torch.ops.fused_resize import fused_resize_plane

    cfg = _config("hevc-ladder")
    y, _, _ = content.smooth_frames(0, 24, 1080, 1920, 3, cuda)
    worst, control = 0.0, []
    for r in cfg["rungs"][1:]:
        (ah, aw), _ = ref_resize.rung_matrices(1080, 1920, r["height"],
                                               r["width"])
        want = ref_resize.resize_plane(y, ah, aw)
        got = fused_resize_plane(y, torch.as_tensor(ah, device=cuda),
                                 torch.as_tensor(aw, device=cuda))
        worst = max(worst, float((want.float() - got.float()).abs().mean()))
        low = ref_resize.resize_plane(y, ah, aw, dtype=torch.bfloat16)
        control.append(float((want.float() - low.float()).abs().mean()))
    assert worst <= cfg["limits"]["resize_mae"] < min(control), (worst, control)
