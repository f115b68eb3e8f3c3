"""One run of one cell: set-up, the measured window, the output check and
the result line.

Everything is found by name from ``BENCHMARK.json``: the cell's
configuration (``configs/<config>/config.json`` and the cfg beside it),
its traffic mix (``traffic/<traffic>.json``, whose ``driver`` names the
general generator in ``drivers/``), its per-layer metrics
(``metrics/<name>.py``, each a ``read(ctx)``) and its limits
(``limits/<workload>.json``). A cell, a mix or a metric is added as new
files and entries, without an edit to this file.
"""

from __future__ import annotations

import argparse
import gc
import importlib.util
import json
import os
import subprocess
import sys
import time

FORBIDDEN = ("jax", "jaxlib", "flax", "double_yolo_kaist_tpu")
THREADS = 4         # torch's host threads: one process, few threads
HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


class Refused(Exception):
    """The run cannot give a result (no card, a bad name, JAX loaded)."""


def load_file_module(path: str, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def read_json(path: str):
    with open(path, encoding="utf-8") as f:
        return json.load(f)


def find(search, *parts) -> str:
    """The first of ``search``'s directories that holds ``parts``."""
    for d in search:
        path = os.path.join(d, *parts)
        if os.path.exists(path):
            return path
    raise Refused(f"no {os.path.join(*parts)} under {list(search)}")


class Cell:
    """The cell's entries and files, found by name. ``search``: the
    directories to look in, the benchmark's own by default (tests put a
    directory of their own first)."""

    def __init__(self, workload: str, bench_path: str | None = None,
                 search=(HERE,)):
        bench = read_json(bench_path or os.path.join(ROOT, "BENCHMARK.json"))
        by = {w["name"]: w for w in bench["workloads"]}
        if workload not in by:
            raise Refused(f"no workload {workload!r} in BENCHMARK.json")
        self.workload = by[workload]
        self.name = workload
        self.search = tuple(search)
        cfile = find(search, "configs", self.workload["config"],
                     "config.json")
        self.config = read_json(cfile)
        self.config["cfg_path"] = os.path.join(os.path.dirname(cfile),
                                               self.config["cfg"])
        self.mix = read_json(find(search, "traffic",
                                  self.workload["traffic"] + ".json"))
        self.driver = load_file_module(
            find(search, "drivers", self.mix["driver"] + ".py"),
            "perfbench_driver_" + self.mix["driver"])
        try:
            self.limits = read_json(find(search, "limits",
                                         workload + ".json"))
        except Refused:
            self.limits = {}
        self.end_to_end = [m for m in bench["end_to_end"]
                           if workload in m.get("workloads", [workload])]
        reported = {m["name"] for m in self.end_to_end}
        self.per_layer = [
            m for m in bench["per_layer"]
            if (workload in m["workloads"] if "workloads" in m
                else m["moves"] in reported)]
        self.chips = int(self.workload["chips"])

    def reader(self, metric: str):
        return load_file_module(
            find(self.search, "metrics", metric + ".py"),
            "perfbench_metric_" + metric.replace(".", "_"))


class Ctx:
    """What the driver and the readers share in one run."""

    def __init__(self, cell: Cell, seed: int, seconds: float, trace: bool,
                 variant: str, device):
        from .reference import cfg as RC
        self.cell = cell
        self.cfg = cell.config
        self.mix = cell.mix
        self.seed = seed
        self.seconds = seconds
        self.traced = trace
        self.variant = variant
        self.device = device
        self.model = RC.build(self.cfg["cfg_path"], self.cfg["yolo_strides"],
                              self.cfg["bf_type"])
        self.e2e: dict = {}         # end-to-end values of the window
        self.counts: dict = {}      # what the driver counted
        self.trace = None           # a perfbench.trace.Trace when traced
        self.attempted = 0
        self.failed = 0


def card(torch) -> dict:
    name = torch.cuda.get_device_name(0)
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20)
        limit = out.stdout.strip().splitlines()[0] if out.stdout else "?"
    except (OSError, subprocess.SubprocessError):
        limit = "?"
    return {"kind": name, "power_limit": limit}


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def set_cache_dirs() -> None:
    """Build and kernel caches at fixed paths inside the checkout."""
    base = os.path.join(ROOT, ".bench_cache")
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
        os.environ[var] = os.path.join(base, sub)
        os.makedirs(os.environ[var], exist_ok=True)


def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--variant", default="program",
                    help="program (the benchmark); control, or a fault "
                         "the driver names, for the check's own readings")
    return ap.parse_args(argv)


def run(argv=None, t_start=None, device=None, bench_path=None,
        search=(HERE,)) -> dict:
    """One run; returns the result line as a dict. ``device``: tests pass
    ``"cpu"`` to skip the look for a card; ``bench_path`` and ``search``:
    a BENCHMARK.json and directories of their own."""
    t_start = time.perf_counter() if t_start is None else t_start
    args = parse(argv)
    cell = Cell(args.workload, bench_path, search)
    set_cache_dirs()
    import torch
    if device is None:
        if not torch.cuda.is_available():
            raise Refused("torch.cuda.is_available() is false")
        if torch.cuda.device_count() < cell.chips:
            raise Refused(f"{torch.cuda.device_count()} cards, the cell "
                          f"asks for {cell.chips}")
        device = torch.device("cuda", 0)
        torch.cuda.set_device(device)
    device = torch.device(device)
    cuda = device.type == "cuda"
    torch.set_num_threads(THREADS)
    ctx = Ctx(cell, args.seed, args.seconds, bool(args.trace), args.variant,
              device)
    drv = cell.driver
    drv.setup(ctx)
    if cuda:
        torch.cuda.synchronize()
    ctx.e2e["setup_s"] = time.perf_counter() - t_start
    if ctx.traced:
        from .trace import Trace
        ctx.trace = Trace()
        with ctx.trace.window(torch):
            drv.window(ctx)
    else:
        drv.window(ctx)
    if cuda:
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated(device)
    else:
        peak = 0
    drv.release(ctx)
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    checks = drv.check(ctx)
    bad = forbidden_modules()
    if bad:
        raise Refused(f"modules loaded that the port must not load: {bad}")
    correct = ctx.failed == 0 and all(
        v["limit"] is not None and v["value"] <= v["limit"]
        for v in checks.values())
    metrics = {}
    if ctx.traced:
        for m in cell.per_layer:
            v = cell.reader(m["name"]).read(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    else:
        for m in cell.end_to_end:
            metrics[m["name"]] = {"value": float(ctx.e2e[m["name"]]),
                                  "unit": m["unit"]}
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": (torch.cuda.get_device_name(device) if cuda else "cpu"),
           "count": cell.chips if cuda else 0,
           "memory_peak_bytes": int(peak)}
    if ctx.traced:
        dev["busy_s"] = ctx.trace.busy_s
        dev["window_s"] = ctx.trace.window_s
    out = {"correct": bool(correct), "attempted": ctx.attempted,
           "failed": ctx.failed, "metrics": metrics, "device": dev}
    if ctx.traced:
        out["breakdown"] = ctx.trace.breakdown
    if cuda:
        out["card"] = card(torch)
    out["counts"] = ctx.counts
    out["checks"] = checks
    return out


def main(t_start: float) -> int:
    try:
        out = run(sys.argv[1:], t_start)
    except Refused as e:
        print(f"perfbench: no result: {e}", file=sys.stderr)
        return 2
    print(f"correct {out['correct']}", file=sys.stderr)
    for name, v in out["checks"].items():
        print(f"check {name} {v['value']} limit {v['limit']}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0
