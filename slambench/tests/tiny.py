"""Small copies of the benchmark's cells, for runs on the CPU: the same
configurations at a 44 x 60 camera, a few iterations and pixels, coarser
NICE grids, a 60-frame stream; a benchmark dict naming them."""

from __future__ import annotations

import copy
import json
import os
from typing import Dict

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def bench_json() -> Dict:
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def tiny_conf(src: str) -> Dict:
    with open(os.path.join(ROOT, "slambench", "configs", src + ".json")) as f:
        conf = json.load(f)
    c = conf["config"]
    c["cam"].update(H=48, W=64, fx=51.7, fy=51.6, cx=31.8, cy=25.5, crop_edge=2)
    c["cam"].pop("crop_size", None)
    c["tracking"].update(iters=8, pixels=128, ignore_edge_W=2, ignore_edge_H=2, lr=0.002)
    c["mapping"].update(iters=6, pixels=96, iters_first=6)
    if conf["model"] == "nice":
        c["grid_len"].update(middle=0.64, fine=0.32, color=0.32)
        c["mapping"]["mapping_window_size"] = 4
    else:
        c["mapping"].update(mapping_window_size=3, every_frame=3, keyframe_every=3, iters=9)
    conf["stream_frames"] = 60
    return conf


def tiny_bench(tmp: str) -> Dict:
    """BENCHMARK.json with small copies of every configuration file under
    ``slambench/configs/`` (written under ``tmp``), each with a strict and
    a loose cell (``<name>.strict``, ``<name>.loose``)."""
    bench = copy.deepcopy(bench_json())
    bench["configs"], bench["workloads"] = [], []
    for name in sorted(os.listdir(os.path.join(ROOT, "slambench", "configs"))):
        name = name[:-len(".json")]
        path = os.path.join(tmp, name + ".json")
        with open(path, "w") as f:
            json.dump(tiny_conf(name), f)
        bench["configs"].append({"name": name, "file": path})
        for mix in ("strict", "loose"):
            bench["workloads"].append({"name": f"{name}.{mix}", "config": name,
                                       "traffic": mix, "chips": 1})
    return bench
