#!/bin/bash
# CPU-only offline preprocessing job of the PyTorch port (the counterpart of
# scripts/preprocess_job.sh; reference: preprocess_job.sh).
# Usage: sbatch scripts/torch_preprocess_job.sh <root_dir> <output_dir> [image_size]
#
# The NIfTI decoder (mrijax_torch/csrc/mrijax_io.cpp) is built with g++ at its
# first use, into mrijax_torch/_build/; a failed build fails the job.
#SBATCH --job-name=mrijax-torch-preprocess
#SBATCH --time=08:00:00
#SBATCH --output=/dev/null

set -euo pipefail
ROOT="${1:?root dir}"
OUT="${2:?output dir}"
SIZE="${3:-128}"

SCRIPT_DIR="$(cd "$(dirname "${BASH_SOURCE[0]}")" && pwd)"
REPO_DIR="$(dirname "$SCRIPT_DIR")"
JOB_ID="${SLURM_JOB_ID:-$(date +%s)}"
LOG_DIR="$SCRIPT_DIR/logs/preprocess/$JOB_ID"
mkdir -p "$LOG_DIR"
cd "$REPO_DIR"

exec python -m mrijax_torch.cli --device cpu preprocess \
  --root-dir "$ROOT" --output-dir "$OUT" --image-size "$SIZE" \
  > "$LOG_DIR/$JOB_ID.out" 2> "$LOG_DIR/$JOB_ID.err"
