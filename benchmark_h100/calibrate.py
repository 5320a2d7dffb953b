"""Readings that the limits of ``traffic/<mix>.json`` are set from; not part
of a benchmark run.

    python3 benchmark_h100/calibrate.py --workload <cell> --seeds 11,12,... \\
        [--control 3] [--half-batch 3] [--out chiprun_out/calibrate.jsonl]

In one process, for every seed: the cell's set-up and the timed path for as
many calls as a run checks (generation) or the three first steps (training),
then the judge's numbers of the program. On the first ``--control`` seeds
also the control's numbers: the reference in float8 (its DDIM update in
bfloat16) put in the program's place and judged the same way. On the first
``--half-batch`` seeds of a training cell also the numbers of the program
with a fault planted: the loss of every step taken over the first half of
the batch alone. One JSON line a reading, on standard output and in
``--out``; a training reading adds, for a look at causes, the first step's
loss gap and the three worst leaves of each gradient and update number.
"""

import argparse
import contextlib
import json
import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from mrijax_torch.diffusion import GaussianDiffusion  # noqa: E402

from benchmark_h100 import harness, judge  # noqa: E402
from benchmark_h100.kind_base import _free  # noqa: E402


@contextlib.contextmanager
def half_batch():
    """Every diffusion loss over the first half of its batch only."""
    original = GaussianDiffusion.p_losses

    def p_losses(self, model_fn, x_start, t, noise):
        h = x_start.shape[0] // 2
        err2 = torch.square(model_fn(self.q_sample(x_start, t, noise), t).float() - noise)
        per_sample = err2[:h].flatten(1).mean(dim=1)
        if self.loss_type == "min_snr":
            snr = self.schedule.snr[t[:h]]
            per_sample = snr.clamp_max(self.min_snr_gamma) / snr * per_sample
        return per_sample.mean()

    GaussianDiffusion.p_losses = p_losses
    try:
        yield
    finally:
        GaussianDiffusion.p_losses = original


def look(readings) -> dict:
    """The first step's loss gap, the losses, and the three worst leaves of
    each leaf-wise number of a training judge."""
    losses_p, losses_r, grad_p, grad_r, delta_p, delta_r = readings
    norms_r = judge.leaf_norms(grad_r)
    worst = {name: sorted(gaps.items(), key=lambda kv: -kv[1])[:3] for name, gaps in (
        ("grad", judge.leaf_gaps(judge.leaf_norms(grad_p), norms_r)),
        ("diff", judge.leaf_diffs(grad_p, grad_r)),
        ("update", judge.leaf_gaps(delta_p, delta_r, judge.moved_leaves(norms_r))))}
    return {"loss1_gap": abs(losses_p[0] - losses_r[0]) / abs(losses_r[0]),
            "losses": [list(losses_p), list(losses_r)], "worst_leaves": worst}


def reading(config, mix, seed, device, calls, control=False, fault=None):
    traffic = harness.load_kind(mix["kind"])(config, mix, seed, device)
    t0 = time.perf_counter()
    with fault() if fault else contextlib.nullcontext():
        traffic.setup()
        traffic.window(0.0, calls)
    traffic.release()
    t1 = time.perf_counter()
    numbers = traffic.judge()
    t2 = time.perf_counter()
    out = {"seed": seed, "program" if fault is None else fault.__name__: numbers,
           "timed_path_s": t1 - t0, "judge_s": t2 - t1}
    if hasattr(traffic, "readings"):
        out["look"] = look(traffic.readings)
    if control:
        out["control"] = traffic.judge(control=True)
    del traffic
    _free(device)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control", type=int, default=3)
    ap.add_argument("--half-batch", type=int, default=0)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    bench = harness.load_benchmark()
    cell = harness.find(bench["workloads"], args.workload, "workload")
    config = json.loads((harness.ROOT / harness.find(bench["configs"], cell["config"], "config")
                         ["file"]).read_text())
    mix = json.loads((harness.BENCH_DIR / "traffic" / f"{cell['traffic']}.json").read_text())
    device = torch.device("cuda", 0)
    calls = mix.get("check", {}).get("calls", 0)
    out = open(args.out, "a") if args.out else None
    for i, seed in enumerate(int(s) for s in args.seeds.split(",")):
        rows = [reading(config, mix, seed, device, calls, control=i < args.control)]
        if i < args.half_batch:
            rows.append(reading(config, mix, seed, device, calls, fault=half_batch))
        for row in rows:
            line = json.dumps({"workload": args.workload, **row})
            print(line, flush=True)
            if out:
                out.write(line + "\n")
                out.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
