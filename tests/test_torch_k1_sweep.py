"""The K1 design sweep (``nice_slam_torch/tools/k1_sweep.py``) on the CPU:
walk_auto's points per team follow the rule the tool states, every
variant names a kernel its sources define, the summary sums the main
path's items and holds the port's K1 to the 3 % rule, and without a card
the tool exits non-zero."""

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


@pytest.mark.parametrize("slower, within", [(1.03, True), (1.031, False)])
def test_summary_sums_the_items_and_holds_the_port_to_3_percent(slower, within):
    """summary: each variant's K1 ms over the main path's items (None for
    one that skipped an item's case), its worst ratio to the baseline and
    where, its largest spread over the rounds; the port's K1 is within the
    rule only if no case is more than 3 % slower than the baseline."""
    lines = []
    for case in [*k1_sweep.ITEM_LAUNCHES, "map_coarse"]:
        t = {"baseline": [1.0, 1.0], "shipped": [0.9, 0.9], "walk_auto": [0.5, 1.5]}
        if case == "map_coarse":
            t["shipped"] = [slower, slower]  # faster elsewhere
            del t["walk_auto"]
        if case == "track":
            del t["walk_auto"]
        lines.append({"case": case, "device_ms": t})
    out = k1_sweep.summary(lines)
    shipped, walk = out["variants"]["shipped"], out["variants"]["walk_auto"]
    assert out["shipped_within_3_percent"] is within
    assert shipped["worst_case"] == "map_coarse"
    assert shipped["worst_ratio_to_baseline"] == pytest.approx(slower)
    assert shipped["items_ms"] == pytest.approx(0.9 * sum(k1_sweep.ITEM_LAUNCHES.values()))
    assert shipped["largest_spread"] == 0.0 and walk["largest_spread"] == pytest.approx(1.0)
    assert walk["items_ms"] is None  # it skipped tracking


def test_without_a_card_the_sweep_exits_nonzero(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert k1_sweep.main([]) == 1
    assert capsys.readouterr().out == ""
