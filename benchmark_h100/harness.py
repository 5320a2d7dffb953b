"""One run of one cell of ``BENCHMARK.json``.

``python3 benchmark_h100/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` from the root of a checkout, on a machine with the cards the
cell asks for:

1. set-up: the cell's configuration (``configs/<config>.json``, named by
   ``BENCHMARK.json``) and traffic mix (``traffic/<mix>.json``), whose
   ``kind`` names the generator, ``kinds/<kind>.py``; the program built,
   weights and pools made on the card from the seed, every shape of the
   timed path warmed up;
2. the window of ``--seconds``;
3. with ``--trace 1``, the traced segment (``tracing.py``) and the
   operation counts (``count/``);
4. the peak memory read, the program freed, its outputs judged against the
   plain reference (``judge.py``, limits in the mix file);
5. the metrics: each one of ``BENCHMARK.json`` that the cell reports (its
   ``workloads``, or every cell) is read by ``metrics/<name>.py``; a reader
   that finds nothing to read is left out;
6. the numbers compared, each with its limit, as the last lines of standard
   error, then one JSON line on standard output.

Without CUDA, or with fewer cards than the cell asks for, the run prints no
result and exits 2. If ``jax``, ``jaxlib``, ``flax`` or ``mrijax`` (compared
by whole top-level module name) is loaded when the window has closed, it
names them and exits 3.
"""

import argparse
import importlib.util
import json
import math
import sys
import time
from pathlib import Path
from typing import Optional

import torch

from benchmark_h100 import judge
from benchmark_h100.count import peaks

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "mrijax")


def load_benchmark(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def find(entries, name: str, what: str) -> dict:
    for e in entries:
        if e["name"] == name:
            return e
    raise SystemExit(f"no {what} named {name!r} in BENCHMARK.json")


def applies(metric: dict, cell: dict) -> bool:
    """Whether ``cell`` reports ``metric``: the cells its ``workloads``
    lists, or every cell."""
    return cell["name"] in metric.get("workloads", (cell["name"],))


def load_file(folder: str, name: str, bench_dir: Path = BENCH_DIR):
    """The module ``<bench_dir>/<folder>/<name>.py``, found by its name."""
    spec = importlib.util.spec_from_file_location(
        f"benchmark_h100_{folder}_" + name.replace(".", "_").replace("-", "_"),
        bench_dir / folder / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def load_kind(kind: str, bench_dir: Path = BENCH_DIR):
    """The traffic class of ``kinds/<kind>.py`` (its ``KIND``)."""
    return load_file("kinds", kind, bench_dir).KIND


def read_metric(name: str, ctx: dict, bench_dir: Path = BENCH_DIR):
    value = load_file("metrics", name, bench_dir).read(ctx)
    return None if value is None else float(value)


def forbidden_modules():
    return sorted(m for m in list(sys.modules) if m.split(".")[0] in FORBIDDEN)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run_cell(bench: dict, cell_name: str, seed: int, seconds: float, trace: bool,
             device: torch.device, energy=None, start: Optional[float] = None,
             root: Path = ROOT, bench_dir: Path = BENCH_DIR, min_calls: int = 0) -> dict:
    """Set up, measure, judge and read one run of ``cell_name``; returns the
    result line as a dict (``check`` last) and leaves printing to the caller."""
    start = time.time() if start is None else start
    cell = find(bench["workloads"], cell_name, "workload")
    config = json.loads((root / find(bench["configs"], cell["config"], "config")["file"])
                        .read_text())
    mix = json.loads((bench_dir / "traffic" / f"{cell['traffic']}.json").read_text())
    traffic = load_kind(mix["kind"], bench_dir)(config, mix, seed, device, trace, energy)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    traffic.setup()
    setup_s = time.time() - start
    marks = traffic.marks
    parts = [("process start to traffic", setup_s - (time.perf_counter() - marks[0][1]))]
    parts += [(what, t - t_prev) for (_, t_prev), (what, t) in zip(marks, marks[1:])]
    print("set-up: " + ", ".join(f"{what} {s:.3f} s" for what, s in parts), file=sys.stderr)
    window = traffic.window(seconds, min_calls)
    traced = traffic.segment_trace() if trace else None
    counts = traffic.counts() if trace else None
    _sync(device)
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    traffic.release()
    numbers = traffic.judge()
    limits = mix["limits"]
    correct = judge.within(numbers, limits) and window["failed"] == 0

    ctx = {"role": traffic.role, "kind": mix["kind"], "setup_s": setup_s, "window": window,
           "trace": traced, "counts": counts, "itemsize": traffic.dtype.itemsize}
    metrics = {}
    for m in bench["per_layer" if trace else "end_to_end"]:
        if applies(m, cell):
            value = read_metric(m["name"], ctx, bench_dir)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
           "count": cell["chips"], "memory_peak_bytes": int(peak)}
    result = {"correct": bool(correct), "attempted": window["attempted"],
              "failed": window["failed"], "metrics": metrics, "device": dev}
    if traced is not None:
        dev["busy_s"], dev["window_s"] = traced["busy_s"], traced["window_s"]
        result["breakdown"] = {"device_ops": traced["device_ops"],
                               "idle_gaps": traced["idle_gaps"]}
    result["check"] = {k: {"value": numbers.get(k, math.nan), "limit": limit}
                       for k, limit in limits.items()}
    return result


def _launch_counts() -> dict:
    from mrijax_torch.kernels import flash_attention, groupnorm

    return {**groupnorm.launches.as_dict(), **flash_attention.launches.as_dict()}


def main(argv=None, start: Optional[float] = None) -> int:
    imported = time.time()
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    bench = load_benchmark()
    cell = find(bench["workloads"], args.workload, "workload")
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"benchmark: cell {cell['name']} needs {cell['chips']} CUDA card(s); "
              f"torch.cuda.is_available() is {torch.cuda.is_available()}, "
              f"{torch.cuda.device_count()} found", file=sys.stderr)
        return 2
    from benchmark_h100.nvml import Nvml

    torch.set_num_threads(4)
    device = torch.device("cuda", 0)
    torch.zeros(1, device=device)
    _sync(device)
    energy = Nvml(0)
    if start is not None:
        print(f"before set-up: process start to imports done {imported - start:.3f} s, "
              f"CUDA context and NVML {time.time() - imported:.3f} s", file=sys.stderr)
    print(f"card: {torch.cuda.get_device_name(device)}, power limit "
          f"{energy.power_limit_w():.2f} W (the peaks of count/peaks.py hold at "
          f"{peaks.POWER_W} W); torch {torch.__version__}, CUDA {torch.version.cuda}",
          file=sys.stderr)
    result = run_cell(bench, args.workload, args.seed, args.seconds, bool(args.trace),
                      device, energy, start)
    found = forbidden_modules()
    if found:
        print("benchmark: modules of JAX or of the JAX package are loaded: "
              + ", ".join(found), file=sys.stderr)
        return 3
    if args.trace:
        print("kernel launches: " + json.dumps(_launch_counts()), file=sys.stderr)
    for name, c in result["check"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0
