"""Whole runs of small cells on the CPU through the harness (its look for
a card skipped): the result line, the import guard, and the comparison
failing on a system broken underneath."""

import ast
import json
import os
import subprocess
import sys
import time

import pytest
import torch

from slambench import harness
from slambench.tests import faults
from slambench.tests.tiny import ROOT, tiny_bench

SEED = 2**31 + 12345


def run_tiny(tmp_path, cell, trace=False, seconds=8.0):
    bench = tiny_bench(str(tmp_path))
    run = harness.Run(cell, SEED, seconds, trace, "cpu", bench, time.perf_counter())
    out = run.execute()
    return run, out, harness.result_line(run, out, bench)


@pytest.mark.parametrize("cell,trace", [("nice_tum.strict", False), ("nice_tum.strict", True),
                                        ("imap_replica.loose", False)])
def test_result_line(tmp_path, cell, trace):
    run, out, line = run_tiny(tmp_path, cell, trace=trace)
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(line)[-1] == "compared"
    assert line["correct"] is True, line["compared"]
    assert set(line["compared"]) == set(run.conf["limits"])
    assert all(v["value"] <= v["limit"] for v in line["compared"].values())
    kinds = {b["kind"] for b in out["judged"]["blocks"]}
    assert {"map_start", "map", "track"} <= kinds
    assert out["found"] == []
    if run.trace:
        assert "map_ms" in line["metrics"] and "window_s" in line["device"]
        assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
    else:
        assert set(line["metrics"]) == {"fps", "track_ms", "setup_s"}
    json.dumps(line)


def test_traced_mlp_work_is_counted_from_the_calls(tmp_path):
    from slambench import flops

    run, out, line = run_tiny(tmp_path, "imap_replica.strict", trace=True)
    conf = run.conf
    c, w, rc = conf["config"], conf["widths"], conf["config"]["rendering"]
    track = c["tracking"]["iters"] * c["tracking"]["pixels"] * flops.imap_ray_flops(
        w, rc["N_samples"], rc["N_importance"], 0, False)
    frames = sum(1 for s, _ in run.clock.tracks if s >= run.clock.t1)
    assert frames >= 1
    rest = flops.imap_flops(conf, run.calls) - frames * track
    # whole mapping events after them: iters iterations of all the pixels
    event = c["mapping"]["iters"] * c["mapping"]["pixels"] * flops.imap_ray_flops(
        w, rc["N_samples"], rc["N_importance"], rc["N_samples"], True)
    assert rest > 0 and rest % event == 0, (rest, event)
    assert "mfu" in line["metrics"]  # mlp_roofline reads the card's GEMM kernels


@pytest.mark.parametrize("cell", ["nice_tum.strict", "imap_replica.strict"])
@pytest.mark.parametrize("fault", ["state_unchanged", "half_batch", "answer_altered"])
def test_a_broken_system_is_not_correct(tmp_path, monkeypatch, cell, fault):
    faults.plant(fault, monkeypatch.setattr)
    _, out, line = run_tiny(tmp_path, cell)
    assert line["correct"] is False, (fault, line["compared"])


def test_a_step_taken_the_other_way_shows_in_step_dir(tmp_path, monkeypatch):
    faults.plant("step_flipped", monkeypatch.setattr)
    _, out, _ = run_tiny(tmp_path, "imap_replica.strict")
    assert out["judged"]["numbers"]["step_dir"] > 1.5, out["judged"]["numbers"]


def test_run_fails_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    p = subprocess.run([sys.executable, "slambench/run.py", "--workload", "imap_replica.strict",
                        "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=ROOT,
                       capture_output=True, text=True, timeout=120)
    assert p.returncode != 0 and p.stdout.strip() == ""


def test_run_fails_in_a_directory_of_the_benchmark_alone(tmp_path):
    import shutil

    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(ROOT, "slambench"), tmp_path / "slambench")
    p = subprocess.run([sys.executable, "slambench/run.py", "--workload", "imap_replica.strict",
                        "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=tmp_path,
                       capture_output=True, text=True, timeout=120)
    assert p.returncode != 0 and p.stdout.strip() == ""


def test_guard_compares_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "jaxtyping_like", sys)
    monkeypatch.setitem(sys.modules, "nice_slam_tpu_notes", sys)
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "jax.numpy", sys)
    assert harness.forbidden_modules() == ["jax"]


def test_reference_imports_nothing_of_the_system():
    ref = os.path.join(ROOT, "slambench", "reference")
    for name in os.listdir(ref):
        if not name.endswith(".py"):
            continue
        tree = ast.parse(open(os.path.join(ref, name)).read())
        for node in ast.walk(tree):
            mods = ([a.name for a in node.names] if isinstance(node, ast.Import) else
                    [node.module or ""] if isinstance(node, ast.ImportFrom) else [])
            for m in mods:
                assert m.split(".")[0] not in ("nice_slam_torch", "nice_slam_tpu", "jax"), (name, m)
    code = ("import sys; sys.path.insert(0, %r); import slambench.reference.core, "
            "slambench.reference.nice, slambench.reference.imap, slambench.check; "
            "bad = {m.split('.')[0] for m in sys.modules} & "
            "{'nice_slam_torch', 'nice_slam_tpu', 'jax', 'jaxlib', 'flax'}; "
            "print(sorted(bad))" % ROOT)
    p = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=120)
    assert p.stdout.strip() == "[]", p.stderr


def test_a_run_loads_no_jax(tmp_path):
    code = ("import sys, time; sys.path.insert(0, %r); import torch; "
            "torch.set_num_threads(2); from slambench import harness; "
            "from slambench.tests.tiny import tiny_bench; "
            "b = tiny_bench(%r); r = harness.Run('nice_tum.strict', 3, 1.0, False, 'cpu', b, "
            "time.perf_counter()); out = r.execute(); print(out['found'], "
            "harness.forbidden_modules())" % (ROOT, str(tmp_path)))
    p = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                       timeout=600, env=dict(os.environ, JAX_PLATFORMS="cpu"))
    assert p.stdout.strip().splitlines()[-1] == "[] []", p.stderr[-2000:]
