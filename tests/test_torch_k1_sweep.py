"""The K1 design sweep (``nice_slam_torch/tools/k1_sweep.py``) on the CPU:
walk_auto's points per team follow the rule the tool states, every
variant names a kernel its sources define, and without a card the tool
exits non-zero."""

import os

import pytest
import torch

from nice_slam_torch.tools import k1_sweep


@pytest.mark.parametrize("n, sms, per_team", [
    (9600, 132, 2),    # tracking: 1200 warps of 8-point runs, >= 8 per SM
    (48000, 132, 8),   # mapping: 1500 warps of 32-point runs
    (32000, 132, 4),   # coarse mapping: 1000 warps at 8 would be < 1056
    (10, 132, 1),      # never below one point per team
])
def test_auto_per_team_halves_until_the_launch_fills_the_card(n, sms, per_team):
    assert k1_sweep.auto_per_team(n, sms) == per_team
    run = 32 // k1_sweep.WALK_LANES * per_team
    assert per_team == 1 or -(-n // run) >= sms * k1_sweep.WALK_WARPS_PER_SM


def test_every_variant_names_a_kernel_of_its_sources():
    from nice_slam_torch.ops import kernels

    src = ""
    for path in (k1_sweep.SOURCE, os.path.join(kernels.CSRC, "trilinear.cu")):
        with open(path) as f:
            src += f.read()
    for name, (match, how) in k1_sweep.VARIANTS.items():
        assert f"{match}(" in src or f"{match}<" in src, name
        if how[0] == "walk":
            per_team, block, min_blocks = how[1:]
            assert per_team in (None, 1, 2, 4, 8)
            assert (block, min_blocks) in ((128, 1), (128, 4), (256, 1))


def test_without_a_card_the_sweep_exits_nonzero(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert k1_sweep.main([]) == 1
    assert capsys.readouterr().out == ""
