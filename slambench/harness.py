"""One run of one cell: set up the system under test from the seed, warm
it up, measure a window, trace a further part of the run where asked,
judge what the window produced against the reference, and say so in one
line.

The system is ``nice_slam_torch``'s ``NiceSLAM``, driven through
``NiceSLAM.run()`` (the strict loop, or the threaded one under ``loose``)
with the benchmark's frame reader.  The benchmark wraps the system's
calls from here: the instance's ``track_one``, ``map_one`` and
``_map_event`` for its clocks (and ``record_function`` ranges in a traced
run), and the functions ``capture.py`` names for the comparison.  The
traced part's work is counted from what those see of every call (its
iterations and rays; ``Readings.calls``) and the configuration's widths;
NICE's decoder calls, whose work depends on which inputs need a
gradient, are counted at the decoder stage's entry.

The window opens at the end of the first main mapping event after the
warm-up (``warmup_frames`` tracked; ``mapping_window``: as many as the
larger of the mapping window and the mapping period) and closes at the
end of the first main mapping event that completes ``seconds`` after it
opened; a strict event is the main call with its coarse call.  In a
traced run the profiler then runs over whole events for at least
``trace_seconds``.  The run is stopped
there, before the stream's last frame and its final refinement.
"""

from __future__ import annotations

import contextlib
import copy
import gc
import importlib.util
import json
import os
import random
import shutil
import sys
import tempfile
import threading
import time
from types import SimpleNamespace
from typing import Any, Dict, List

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HERE = os.path.dirname(os.path.abspath(__file__))
FORBIDDEN = ("jax", "jaxlib", "flax", "nice_slam_tpu")


class StopWindow(Exception):
    """Raised from the benchmark's wrapper once the measured part is over."""


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is one of FORBIDDEN, whole."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def load_json(path: str) -> Any:
    with open(path) as f:
        return json.load(f)


def find_cell(bench: Dict, workload: str, here: str = HERE):
    """(cell, configuration file, traffic file) of a workload name; the
    files found by the names ``BENCHMARK.json`` gives (traffic under
    ``here``/traffic)."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    cell = cells[workload]
    confs = {c["name"]: c for c in bench["configs"]}
    conf = load_json(os.path.join(ROOT, confs[cell["config"]]["file"]))
    traffic = load_json(os.path.join(here, "traffic", cell["traffic"] + ".json"))
    return cell, conf, traffic


def per_layer_modules(bench: Dict, workload: str, here: str = HERE):
    """The per-layer metrics that apply to a cell, each its module."""
    out = {}
    for m in bench["per_layer"]:
        if "workloads" in m and workload not in m["workloads"]:
            continue
        path = os.path.join(here, "metrics", m["name"] + ".py")
        spec = importlib.util.spec_from_file_location("slambench_metric_" + m["name"], path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        out[m["name"]] = mod
    return out


def camera(cfg: Dict) -> Dict[str, Any]:
    """The camera frames are rendered at: the configured one resized to
    ``crop_size``, then ``crop_edge`` cut from every side."""
    c = cfg["cam"]
    H, W, fx, fy, cx, cy = c["H"], c["W"], c["fx"], c["fy"], c["cx"], c["cy"]
    if c.get("crop_size"):
        th, tw = c["crop_size"]
        fx, cx, fy, cy = fx * tw / W, cx * tw / W, fy * th / H, cy * th / H
        H, W = th, tw
    e = c.get("crop_edge", 0)
    return {"H": H - 2 * e, "W": W - 2 * e, "fx": fx, "fy": fy, "cx": cx - e, "cy": cy - e}


class Clock:
    """The window's state, fed by the wrappers on the system's threads."""

    def __init__(self, traffic: Dict, seconds: float, trace: bool, warmup: int):
        self.lock = threading.Lock()
        self.warmup = warmup
        self.seconds = float(seconds)
        self.trace_seconds = float(traffic["trace_seconds"]) if trace else 0.0
        self.tracked = 0
        self.t0 = self.t1 = None
        self.tracks: List[tuple] = []     # (start, end) of each tracked frame
        self.t_trace = None
        self.on_open = self.on_close = self.on_trace_end = None
        self.done = False

    def track_done(self, s: float, e: float) -> None:
        with self.lock:
            self.tracked += 1
            self.tracks.append((s, e))

    def event_done(self, t: float) -> None:
        """A main mapping event ended at ``t``; raises StopWindow when the
        run has measured (and traced) all it will."""
        with self.lock:
            if self.done:
                raise StopWindow()
            if self.t0 is None:
                if self.tracked >= self.warmup:
                    self.t0 = t
                    if self.on_open:
                        self.on_open()
                return
            if self.t1 is None:
                if t - self.t0 >= self.seconds:
                    self.t1 = t
                    if self.on_close:
                        self.on_close()
                    if not self.trace_seconds:
                        self.done = True
                        raise StopWindow()
                    self.t_trace = time.perf_counter()
                return
            if t - self.t_trace >= self.trace_seconds:
                self.done = True
                if self.on_trace_end:
                    self.on_trace_end()
                raise StopWindow()

    def in_window(self) -> bool:
        return self.t0 is not None and self.t1 is None


def warmup_frames(traffic: Dict, cfg: Dict) -> int:
    w = traffic["warmup_frames"]
    if w == "mapping_window":
        m = cfg["mapping"]
        return max(int(m["mapping_window_size"]), int(m["every_frame"]))
    return int(w)


def profiler(torch):
    """A profiler of the host and the card that records every thread's
    ranges (where this PyTorch offers it)."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    try:
        from torch._C._profiler import _ExperimentalConfig

        return torch.profiler.profile(activities=acts, experimental_config=_ExperimentalConfig(
            profile_all_threads=True))
    except (ImportError, TypeError):
        return torch.profiler.profile(activities=acts)


class Readings(SimpleNamespace):
    """What the per-layer metrics read (see ``metrics/__init__.py``)."""


def build_cfg(conf: Dict, traffic: Dict, seed: int, out_dir: str) -> Dict:
    cfg = copy.deepcopy(conf["config"])
    cfg["sync_method"] = traffic["schedule"]
    cfg["seed"] = int(seed)
    cfg["verbose"] = False
    cfg["dataset"] = "synthetic"
    cfg["data"] = dict(cfg.get("data", {}), output=out_dir, n_frames=int(conf["stream_frames"]))
    pd = cfg.get("pretrained_decoders", {})
    for k, v in list(pd.items()):
        pd[k] = os.path.join(ROOT, v) if v else ""
    return cfg


def live_share(tree, room, device) -> float:
    """Share of points in the room where a density MLP's output is positive."""
    import torch

    g = torch.Generator(device=device)
    g.manual_seed(0)
    r = torch.as_tensor(room, dtype=torch.float32, device=device)
    p = r[:, 0] + (r[:, 1] - r[:, 0]) * torch.rand((4096, 3), generator=g, device=device)
    h = torch.sin(p @ tree["embedder_B"])
    for layer in tree["pts_linears"]:
        h = torch.relu(h @ layer["w"] + layer["b"])
    sigma = (h @ tree["output_linear"]["w"] + tree["output_linear"]["b"])[:, 3]
    return float((sigma > 0).float().mean())


class Run:
    """One run of a cell on ``device``."""

    def __init__(self, workload: str, seed: int, seconds: float, trace: bool, device: str,
                 bench: Dict, t_start: float, control: bool = False, here: str = HERE):
        self.workload, self.seed, self.seconds, self.trace = workload, int(seed), seconds, trace
        self.device, self.bench, self.t_start, self.control = device, bench, t_start, control
        self.cell, self.conf, self.traffic = find_cell(bench, workload, here)
        self.metrics = per_layer_modules(bench, workload, here) if trace else {}
        self.counts: Dict[str, float] = {}
        self.calls: List[tuple] = []
        self.counting = False

    # -- what the comparison keeps --------------------------------------------------
    def _chooser(self):
        rng = random.Random(self.seed * 1_000_003 + 17)
        # the window's first tracked frame and mapping calls, and others drawn
        plan = {"track": {0, *rng.sample(range(1, 6), 3)}, "map": {0, *rng.sample(range(1, 6), 3)},
                "coarse": {0, *rng.sample(range(1, 4), 1)}}
        rngs = {k: random.Random(rng.random()) for k in plan}
        seen = {k: 0 for k in plan}
        first = {"map": True}
        lock = threading.Lock()
        nice = self.conf["model"] == "nice"
        m = self.conf["config"]["mapping"]

        def want(kind, info):
            with lock:
                self._count(kind, info)
                if kind == "map" and info.get("coarse"):
                    kind = "coarse"
                if kind == "map" and first["map"]:
                    first["map"] = False
                    return {"k": 0, "own": True}
                if not self.clock.in_window() or info["iters"] < 1:
                    return None
                n = seen[kind]
                seen[kind] += 1
                if n not in plan[kind]:
                    return None
                iters = info["iters"]
                lo = 0
                if kind == "map" and nice and n in sorted(plan["map"])[:2]:
                    # two blocks in the colour stage, where every kernel runs
                    lo = min(iters - 1, int(iters * m["fine_iter_ratio"]) + 1)
                return rngs[kind].randrange(lo, iters)
        return want

    def _count(self, kind: str, info: Dict) -> None:
        """Every call that starts in the traced part, as the comparison's
        wrappers see it: the metrics count work from these."""
        if self.counting:
            self.calls.append((kind, dict(info)))

    # -- the run -------------------------------------------------------------------------
    def execute(self) -> Dict[str, Any]:
        import numpy as np
        import torch

        from slambench import capture, check, frames, weights
        from nice_slam_torch.slam.slam import NiceSLAM

        dev = torch.device(self.device)
        conf, traffic = self.conf, self.traffic
        nice = conf["model"] == "nice"
        tmp_root = os.environ.get("TMPDIR") or tempfile.gettempdir()
        out_dir = tempfile.mkdtemp(prefix="slambench-", dir=tmp_root)
        try:
            cfg = build_cfg(conf, traffic, self.seed, out_dir)
            cam = camera(cfg)
            room = np.asarray(cfg["mapping"]["bound"], dtype=np.float64)
            room = room + np.array([conf["room_inset"], -conf["room_inset"]])
            reader = frames.make_reader(room, cam, cfg["scale"], traffic,
                                        int(conf["stream_frames"]), self.seed, dev)
            slam = NiceSLAM(cfg, SimpleNamespace(nice=nice, output=out_dir),
                            devices=[self.device])
            slam.frame_reader = reader
            shapes = check.grid_shapes(cfg, nice)
            if shapes != dict(slam.spec.grid_shapes):
                raise RuntimeError(f"grid shapes {shapes} != the system's {slam.spec.grid_shapes}")
            grids, decs = weights.make(conf, shapes, self.seed, dev)
            attempt = 0
            while not nice and attempt < 64 and live_share(decs["imap"], np.asarray(cfg["mapping"]["bound"]) *
                                          cfg["scale"], dev) < conf["init"]["min_live_share"]:
                attempt += 1  # a draw whose density is negative nearly everywhere never trains
                sub = (self.seed * 1_000_003 + attempt) % (1 << 62)
                if attempt == 64:
                    raise RuntimeError("no MLP draw of this seed has a live density")
                grids, decs = weights.make(conf, shapes, sub, dev)
            decoders = (dict(slam.state.decoders, color=decs["color"]) if nice else decs["imap"])
            slam.state = slam.state._replace(grids=grids, decoders=decoders)
            self.own = {**grids} if nice else {}
            for name, tree in decs.items():
                prefix = "dec_color/" if nice else "dec/"
                self.own.update({prefix + n: t for n, t in weights.flatten(tree)})
            self.clock = Clock(traffic, self.seconds, self.trace, warmup_frames(traffic, cfg))
            rec = capture.Recorder(self._chooser())
            rec.install()
            self._wrap(slam)
            if self.trace:  # the profiler's first start on this thread, in set-up
                with profiler(torch):
                    pass
            stopped = False
            try:
                slam.run()
            except StopWindow:
                stopped = True
            except RuntimeError as e:
                stopped = isinstance(e.__cause__, StopWindow)
                if not stopped:
                    raise
            finally:
                self._unwrap_counts()
                rec.uninstall()
            if not stopped or self.clock.t1 is None:
                raise RuntimeError("the stream ended before the window closed")
            cuda = dev.type == "cuda"
            if cuda:
                torch.cuda.synchronize(dev)
            peak = int(torch.cuda.max_memory_allocated(dev)) if cuda else 0
            found = forbidden_modules()
            result = self._end_to_end(slam)
            result["_pose_err"] = self._pose_errors(slam)
            readings = None
            if self.trace:
                readings = self._readings(slam)
            kind = torch.cuda.get_device_name(dev) if cuda else "cpu"
            del slam
            gc.collect()
            if cuda:
                torch.cuda.empty_cache()
            judged = self._judge(rec.blocks, cam, reader)
            return {"found": found, "peak": peak, "kind": kind, "e2e": result,
                    "readings": readings, "judged": judged}
        finally:
            shutil.rmtree(out_dir, ignore_errors=True)

    # -- clocks and ranges -------------------------------------------------------------------
    def _wrap(self, slam) -> None:
        import torch

        clock = self.clock
        rf = torch.profiler.record_function
        tracing = lambda: self.counting  # noqa: E731
        strict = slam.sync_method == "strict"
        orig_track, orig_map, orig_event = slam.track_one, slam.map_one, slam._map_event

        def track_one(*a, **k):
            s = time.perf_counter()
            with (rf("slambench.track_one") if tracing() else contextlib.nullcontext()):
                orig_track(*a, **k)
            clock.track_done(s, time.perf_counter())

        self.counts["iters_per_frame"] = slam.tcfg.iters

        def map_one(idx, color, depth, gt_c2w, init, coarse=False, sync=True):
            name = "slambench.coarse_map_one" if coarse else "slambench.map_one"
            with (rf(name) if tracing() else contextlib.nullcontext()):
                orig_map(idx, color, depth, gt_c2w, init, coarse=coarse, sync=sync)
            if not strict and not coarse:
                clock.event_done(time.perf_counter())

        def map_event(*a, **k):
            orig_event(*a, **k)
            if strict:
                clock.event_done(time.perf_counter())

        slam.track_one, slam.map_one, slam._map_event = track_one, map_one, map_event
        self.timings_at = {}
        clock.on_open = lambda: self.timings_at.__setitem__("t0", dict(slam.timings))
        prof_box = {}

        def on_close():
            self.timings_at["t1"] = dict(slam.timings)
            if self.trace:
                self._count_work()
                prof = profiler(torch)
                prof.__enter__()
                self.counting = True
                win = rf("slambench.window")
                win.__enter__()
                prof_box.update(prof=prof, win=win)

        def on_trace_end():
            if torch.cuda.is_available():
                torch.cuda.synchronize()
            prof_box["win"].__exit__(None, None, None)
            self.counting = False
            prof_box["prof"].__exit__(None, None, None)

        clock.on_close, clock.on_trace_end = on_close, on_trace_end
        self.prof_box = prof_box

    # -- counting the traced part's work -------------------------------------------------------
    def _count_work(self) -> None:
        """NICE: wrap the decoder stage's entry, which every decoder call
        of the port goes through, to count each call's work."""
        if self.conf["model"] != "nice":
            return
        import nice_slam_torch.ops.decoder_stage as DS
        import torch

        from slambench import flops

        pk = flops.peaks()
        w = self.conf["widths"]
        c = self.conf["config"]["model"]["c_dim"]
        counts = self.counts
        run = self
        orig = DS.decoder_stage
        self._saved_counts = [(DS, "decoder_stage", orig)]

        def add(key, v):
            counts[key] = counts.get(key, 0) + v

        def decoder_stage(p, decs, feats, weights_):
            if run.counting:
                need_p = p.requires_grad
                need_f = [f.requires_grad for f in feats]
                need_w = [x.requires_grad for x in weights_]
                bwd_runs = torch.is_grad_enabled() and (need_p or any(need_f) or any(need_w))
                fwd, bwd = flops.dec_work(w, c, decs, need_p, need_f,
                                          need_w if bwd_runs else [False] * len(decs))
                if not bwd_runs:
                    bwd = 0
                n = p.shape[0]
                fl = 2.0 * (fwd + bwd) * n
                by = n * flops.dec_bytes(c, decs, len(feats), need_p, need_f, bwd_runs)
                add("dec_flops", fl)
                add("dec_least_s", max(fl / pk["f32_flops_per_s"], by / pk["hbm_bytes_per_s"]))
            return orig(p, decs, feats, weights_)

        DS.decoder_stage = decoder_stage

    def _unwrap_counts(self) -> None:
        for owner, name, fn in getattr(self, "_saved_counts", []):
            setattr(owner, name, fn)
        self._saved_counts = []
        if self.counting:
            self.counting = False
            box = self.prof_box
            with contextlib.suppress(Exception):
                box["win"].__exit__(None, None, None)
                box["prof"].__exit__(None, None, None)

    # -- the numbers ---------------------------------------------------------------------
    def _end_to_end(self, slam) -> Dict[str, float]:
        c = self.clock
        t0, t1 = c.t0, c.t1
        inside = [(s, e) for s, e in c.tracks if t0 < e <= t1]
        frames = len(inside)
        out = {"setup_s": t0 - self.t_start}
        if frames:
            out["fps"] = frames / (t1 - t0)
            out["track_ms"] = 1e3 * sum(e - s for s, e in inside) / frames
        out["_window_s"] = t1 - t0
        out["_frames"] = frames
        return out

    def _pose_errors(self, slam) -> Dict[str, float]:
        """Translation (m) and rotation (deg) error of the tracked frames'
        poses against the stream's true ones: a diagnostic, not compared."""
        import numpy as np

        est = slam.estimate_c2w_list.detach().cpu().numpy()
        gt = slam.gt_c2w_list
        n = max(int(slam.idx), 1)
        t = np.linalg.norm(est[1:n + 1, :3, 3] - gt[1:n + 1, :3, 3], axis=-1)
        r = [np.degrees(np.arccos(np.clip((np.trace(a[:3, :3].T @ b[:3, :3]) - 1) / 2, -1, 1)))
             for a, b in zip(est[1:n + 1], gt[1:n + 1])]
        return {"frames": n, "t_m": [round(float(x), 4) for x in t[:40]],
                "t_median_m": float(np.median(t)), "t_max_m": float(np.max(t)),
                "t_last_m": float(t[-1]), "r_median_deg": float(np.median(r)),
                "r_max_deg": float(np.max(r))}

    def _readings(self, slam) -> Readings:
        from slambench import flops
        from slambench.trace import Trace

        # where no call passed the entries the counts are taken at, the port's path changed
        # under them: say so rather than leave the metrics out
        if not self.calls:
            raise RuntimeError("no tracking or mapping call in the traced part passed the "
                               "entries the benchmark intercepts")
        if self.conf["model"] == "nice" and not self.counts.get("dec_flops"):
            raise RuntimeError("no decoder call in the traced part passed decoder_stage")
        a, b = self.timings_at["t0"], self.timings_at["t1"]
        window = {"map_s": (b["mapping_s"] - a["mapping_s"])
                  + (b["coarse_mapping_s"] - a["coarse_mapping_s"]),
                  "map_events": b["mapping_events"] - a["mapping_events"]}
        trace = Trace.from_profile(self.prof_box["prof"])
        return Readings(trace=trace, counts=dict(self.counts), calls=list(self.calls),
                        window=window, conf=self.conf, peaks=flops.peaks())

    def _judge(self, blocks, cam, reader) -> Dict[str, Any]:
        import torch

        from slambench import check

        mod = importlib.import_module("slambench.reference." + self.conf["model"])
        dev = torch.device(self.device)
        fixed = mod.load(self.conf, ROOT, dev)
        _, color0, depth0, pose0 = reader[0]
        frame0 = {"colors": torch.as_tensor(color0, device=dev)[None],
                  "depths": torch.as_tensor(depth0, device=dev)[None],
                  "fixed_c2w": torch.as_tensor(pose0, device=dev)[None],
                  "opt_mask": torch.zeros(1, device=dev),
                  "frame_valid": torch.ones(1, dtype=torch.bool, device=dev)}
        ctx = check.Context(self.conf, cam, mod, fixed, self.own, frame0, dev)
        return check.judge(ctx, list(blocks), self.conf["limits"], control=self.control)


def result_line(run: Run, out: Dict[str, Any], bench: Dict) -> Dict[str, Any]:
    """The run's result line (the last of standard output)."""
    judged = out["judged"]
    e2e = out["e2e"]
    metrics: Dict[str, Dict[str, Any]] = {}
    units = {m["name"]: m["unit"] for m in bench["end_to_end"] + bench["per_layer"]}
    if run.trace:
        r = out["readings"]
        for name, mod in run.metrics.items():
            v = mod.read(r)
            if v is not None:
                metrics[name] = {"value": float(v), "unit": units[name]}
    else:
        for m in bench["end_to_end"]:
            if "workloads" in m and run.workload not in m["workloads"]:
                continue
            if m["name"] in e2e:
                metrics[m["name"]] = {"value": float(e2e[m["name"]]), "unit": m["unit"]}
    device = {"platform": "gpu", "kind": out["kind"], "count": 1,
              "memory_peak_bytes": out["peak"]}
    limits = run.conf["limits"]
    line: Dict[str, Any] = {"correct": bool(judged["correct"]),
                            "attempted": len(judged["blocks"]),
                            "failed": sum(1 for b in judged["blocks"]
                                          if any(b[k] > v for k, v in limits.items())),
                            "metrics": metrics, "device": device}
    if run.trace:
        t = out["readings"].trace
        device["busy_s"] = t.busy_ns() / 1e9
        device["window_s"] = t.window_ns() / 1e9
        line["breakdown"] = {"device_ops": t.top_ops(10), "idle_gaps": t.idle_by_activity(10)}
        line["trace_lost"] = t.lost()
    line["compared"] = {k: {"value": judged["numbers"][k], "limit": v} for k, v in limits.items()}
    return line
