"""BENCHMARK.json against the rules of its format (names, units, bounds,
the time a full check of 24 cells takes), and every file it names found
by name."""

import json
import os
import re
import shutil

import pytest

from slambench import harness
from slambench.tests.tiny import ROOT, bench_json

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def one_line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_keys_names_and_units():
    b = bench_json()
    assert set(b) == {"command", "paths", "run_seconds", "configs", "workloads",
                      "end_to_end", "per_layer"}
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) <= 64 * 1024
    assert 1 <= len(b["paths"]) <= 16 and all(PATH.match(p) and ".." not in p for p in b["paths"])
    assert len(b["command"]) <= 32 and all(one_line(w) and not w.startswith("/") for w in b["command"])
    assert isinstance(b["run_seconds"], int) and 1 <= b["run_seconds"] <= 51
    # a full check of 24 cells fits its time
    assert (2 + 14 * 24) * (b["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200
    names = set()
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and one_line(c["source"]) and one_line(c["why"])
        assert len(c["reduced"]) <= 16 and all(NAME.match(k) for k in c["reduced"])
        assert c["file"].startswith(b["paths"][0] + "/")
        with open(os.path.join(ROOT, c["file"])) as f:
            conf = json.load(f)
        assert conf["reduced"] == c["reduced"] and conf["source"] == c["source"]
        for k in c["reduced"]:  # never a width
            assert not re.search(r"(_dim|_rank|hidden|width|size|heads)$", k)
        names.add(c["name"])
    used = {w["config"] for w in b["workloads"]}
    assert used == names
    pairs = set()
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"]) and one_line(w["why"])
        assert w["chips"] in (1, 4)
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
    assert sum(w["chips"] == 4 for w in b["workloads"]) <= max(1, len(b["workloads"]) // 4)
    e2e = {m["name"]: m for m in b["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in b["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher") and m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in b["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and one_line(m["layer"])
        assert m["better"] in ("lower", "higher") and m["source"] in SOURCES
        assert m["moves"] in e2e
        for w in m.get("workloads", []):
            assert w in {x["name"] for x in b["workloads"]}
    metric_names = [m["name"] for m in b["end_to_end"] + b["per_layer"]]
    assert len(metric_names) == len(set(metric_names))


@pytest.mark.parametrize("cell", [w["name"] for w in bench_json()["workloads"]])
def test_every_file_found_by_name(cell):
    b = bench_json()
    _, conf, traffic = harness.find_cell(b, cell)
    assert conf["model"] in ("nice", "imap") and traffic["schedule"] in ("strict", "loose")
    mods = harness.per_layer_modules(b, cell)
    want = [m for m in b["per_layer"] if "workloads" not in m or cell in m["workloads"]]
    assert sorted(mods) == sorted(m["name"] for m in want)
    for m in want:
        mod = mods[m["name"]]
        assert (mod.UNIT, mod.LAYER, mod.SOURCE, mod.MOVES) == (
            m["unit"], m["layer"], m["source"], m["moves"])


def test_new_mix_metric_and_configuration_are_files_only(tmp_path):
    """A later change adds a traffic mix, a per-layer metric and a
    configuration as files of their own and entries in BENCHMARK.json."""
    b = bench_json()
    shutil.copytree(os.path.join(ROOT, "slambench", "metrics"), tmp_path / "metrics")
    for sub in ("traffic", "configs"):
        (tmp_path / sub).mkdir()
    with open(os.path.join(ROOT, "slambench", "traffic", "strict.json")) as f:
        mix = json.load(f)
    mix["ring"] = 7
    (tmp_path / "traffic" / "burst.json").write_text(json.dumps(mix))
    (tmp_path / "metrics" / "frames_traced.py").write_text(
        'UNIT, LAYER, SOURCE, MOVES = "frames", "tracker", "program_counter", "fps"\n'
        "def read(r):\n    return None\n")
    with open(os.path.join(ROOT, "slambench", "configs", "nice_tum.json")) as f:
        conf = json.load(f)
    conf["config"]["mapping"]["mapping_window_size"] = 5
    (tmp_path / "configs" / "nice_small.json").write_text(json.dumps(conf))
    b["configs"].append({"name": "nice_small", "source": "x", "why": "x", "reduced": [],
                         "file": str(tmp_path / "configs" / "nice_small.json")})
    b["workloads"].append({"name": "nice_small.burst", "config": "nice_small",
                           "traffic": "burst", "chips": 1, "why": "x"})
    b["per_layer"].append({"name": "frames_traced", "unit": "frames", "better": "higher",
                           "source": "program_counter", "layer": "tracker", "moves": "fps",
                           "workloads": ["nice_small.burst"]})
    _, conf2, mix2 = harness.find_cell(b, "nice_small.burst", here=str(tmp_path))
    assert mix2["ring"] == 7 and conf2["config"]["mapping"]["mapping_window_size"] == 5
    mods = harness.per_layer_modules(b, "nice_small.burst", here=str(tmp_path))
    assert mods["frames_traced"].read(None) is None

