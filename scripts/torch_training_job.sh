#!/bin/bash
# SLURM wrapper for single-GPU training with the PyTorch port (the
# counterpart of scripts/training_job.sh).
# Usage: sbatch scripts/torch_training_job.sh <preset|config.json> [extra cli args...]
#
# Functional parity with the reference's job_submission_scripts/
# training_job.sh: per-job log directory, SIGUSR1 sent 600 s before the time
# limit (the trainer checkpoints and exits cleanly). Memory, steps and energy
# come from the run's own metrics.jsonl (mrijax_torch/obs/analyze.py).
#SBATCH --job-name=mrijax-torch-train
#SBATCH --time=24:00:00
#SBATCH --gres=gpu:1
#SBATCH --signal=SIGUSR1@600
#SBATCH --output=/dev/null

set -euo pipefail

ARG1="${1:?usage: torch_training_job.sh <preset|config.json> [cli args...]}"
shift || true

SCRIPT_DIR="$(cd "$(dirname "${BASH_SOURCE[0]}")" && pwd)"
REPO_DIR="$(dirname "$SCRIPT_DIR")"
JOB_ID="${SLURM_JOB_ID:-$(date +%s)}"
LOG_DIR="$SCRIPT_DIR/logs/train/$JOB_ID"
mkdir -p "$LOG_DIR"

cd "$REPO_DIR"

if [[ "$ARG1" == *.json ]]; then
  CFG_ARGS=(--config "$ARG1")
else
  CFG_ARGS=(--preset "$ARG1")
fi

# several cards: scripts/torch_training_job_multihost.sh (torchrun, one
# process per card)
exec python -m mrijax_torch.cli train "${CFG_ARGS[@]}" "$@" \
  > "$LOG_DIR/$JOB_ID.out" 2> "$LOG_DIR/$JOB_ID.err"
