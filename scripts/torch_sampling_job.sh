#!/bin/bash
# Single-GPU generation/visualization job of the PyTorch port (the
# counterpart of scripts/sampling_job.sh; reference: visualization_jobs.sh).
# Usage: sbatch scripts/torch_sampling_job.sh <run_dir> [sample cli args...]
#SBATCH --job-name=mrijax-torch-sample
#SBATCH --time=04:00:00
#SBATCH --gres=gpu:1
#SBATCH --output=/dev/null

set -euo pipefail
RUN_DIR="${1:?run dir}"
shift || true

SCRIPT_DIR="$(cd "$(dirname "${BASH_SOURCE[0]}")" && pwd)"
REPO_DIR="$(dirname "$SCRIPT_DIR")"
JOB_ID="${SLURM_JOB_ID:-$(date +%s)}"
LOG_DIR="$SCRIPT_DIR/logs/sample/$JOB_ID"
mkdir -p "$LOG_DIR"
cd "$REPO_DIR"

exec python -m mrijax_torch.cli sample --run-dir "$RUN_DIR" "$@" \
  > "$LOG_DIR/$JOB_ID.out" 2> "$LOG_DIR/$JOB_ID.err"
