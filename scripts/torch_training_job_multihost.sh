#!/bin/bash
# SLURM wrapper for MULTI-NODE training with the PyTorch port — the
# counterpart of scripts/training_job_multihost.sh and the analog of the
# reference's job_submission_scripts/training_job_DDP.sh.
#
# One torchrun per node starts one process per card (--nproc_per_node), all
# meeting at the rendezvous endpoint of node 0. Each process runs
# `python -m mrijax_torch.cli train ...`: the CLI sees torchrun's
# WORLD_SIZE > 1 and joins the process group (NCCL), and
# mrijax_torch.parallel.initialize puts each process on the card of its
# LOCAL_RANK. Every rank trains on its rows of each batch; rank 0 alone
# writes the run directory, checkpoints and metrics.
#
# Usage:
#   sbatch --nodes=N scripts/torch_training_job_multihost.sh <preset|config.json> [cli args...]
# or by hand on each of N nodes (node 0's address as the endpoint):
#   MRIJAX_COORD=node0:12355 MRIJAX_NNODES=2 MRIJAX_NODE_RANK=<rank> \
#   MRIJAX_GPUS_PER_NODE=8 scripts/torch_training_job_multihost.sh <preset|config.json>
#SBATCH --job-name=mrijax-torch-train-mh
#SBATCH --time=24:00:00
#SBATCH --ntasks-per-node=1
#SBATCH --signal=SIGUSR1@600
#SBATCH --output=/dev/null

set -euo pipefail

ARG1="${1:?usage: torch_training_job_multihost.sh <preset|config.json> [cli args...]}"
shift || true

SCRIPT_DIR="$(cd "$(dirname "${BASH_SOURCE[0]}")" && pwd)"
REPO_DIR="$(dirname "$SCRIPT_DIR")"
JOB_ID="${SLURM_JOB_ID:-$(date +%s)}"

# node rank / node count / cards a node / endpoint: SLURM first, explicit env second
if [[ -n "${SLURM_PROCID:-}" ]]; then
  NODE_RANK="${SLURM_NODEID:-$SLURM_PROCID}"
  NNODES="${SLURM_NNODES:-${SLURM_NTASKS:-1}}"
  GPUS="${SLURM_GPUS_ON_NODE:-${MRIJAX_GPUS_PER_NODE:-1}}"
  COORD_HOST="$(scontrol show hostnames "$SLURM_JOB_NODELIST" | head -n1)"
  COORD="${COORD_HOST}:${MRIJAX_COORD_PORT:-12355}"
else
  NODE_RANK="${MRIJAX_NODE_RANK:?set MRIJAX_NODE_RANK (the rank of this node) outside SLURM}"
  NNODES="${MRIJAX_NNODES:?set MRIJAX_NNODES (number of nodes) outside SLURM}"
  GPUS="${MRIJAX_GPUS_PER_NODE:?set MRIJAX_GPUS_PER_NODE (processes a node) outside SLURM}"
  COORD="${MRIJAX_COORD:?set MRIJAX_COORD (node0:port) outside SLURM}"
fi

LOG_DIR="$SCRIPT_DIR/logs/train/$JOB_ID"
mkdir -p "$LOG_DIR"
cd "$REPO_DIR"

if [[ "$ARG1" == *.json ]]; then
  CFG_ARGS=(--config "$ARG1")
else
  CFG_ARGS=(--preset "$ARG1")
fi

echo "[multihost] node $NODE_RANK/$NNODES, $GPUS processes, endpoint=$COORD logs=$LOG_DIR"

exec torchrun --nnodes "$NNODES" --nproc_per_node "$GPUS" --node_rank "$NODE_RANK" \
  --rdzv_endpoint "$COORD" -m mrijax_torch.cli train "${CFG_ARGS[@]}" "$@" \
  > "$LOG_DIR/${JOB_ID}_n${NODE_RANK}.out" 2> "$LOG_DIR/${JOB_ID}_n${NODE_RANK}.err"
