#!/usr/bin/env bash
# SLURM evaluation launcher of the port (counterpart of the JAX package's
# tools/slurm_test.sh): one srun task per card, as tools/slurm_train.sh
# launches training; each rank evaluates its shard and rank 0 scores.
#
#   [GPUS=N] [GPUS_PER_NODE=G] [CPUS_PER_TASK=C] [SRUN_ARGS=...] \
#     vitpose_tpu_torch/tools/slurm_test.sh PARTITION JOB_NAME CONFIG \
#       CHECKPOINT [PY_ARGS...]
set -x

PARTITION=$1
JOB_NAME=$2
CONFIG=$3
CHECKPOINT=$4
GPUS=${GPUS:-8}
GPUS_PER_NODE=${GPUS_PER_NODE:-$((GPUS < 8 ? GPUS : 8))}
CPUS_PER_TASK=${CPUS_PER_TASK:-8}
SRUN_ARGS=${SRUN_ARGS:-""}
PY_ARGS=${@:5}
ROOT="$(cd "$(dirname "$0")/../.." && pwd)"

PYTHONPATH="$ROOT${PYTHONPATH:+:$PYTHONPATH}" \
srun -p ${PARTITION} \
    --job-name=${JOB_NAME} \
    --gres=gpu:${GPUS_PER_NODE} \
    --ntasks=${GPUS} \
    --ntasks-per-node=${GPUS_PER_NODE} \
    --cpus-per-task=${CPUS_PER_TASK} \
    --kill-on-bad-exit=1 \
    ${SRUN_ARGS} \
    python -u -m vitpose_tpu_torch.tools.test ${CONFIG} ${CHECKPOINT} \
        ${PY_ARGS}
