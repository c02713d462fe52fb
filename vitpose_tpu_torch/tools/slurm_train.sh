#!/usr/bin/env bash
# SLURM training launcher of the port (counterpart of the JAX package's
# tools/slurm_train.sh and the reference's): srun starts one task per card,
# and parallel/distributed.py's init_distributed reads SLURM_PROCID,
# SLURM_NTASKS, SLURM_LOCALID and the first host of SLURM_JOB_NODELIST (or
# MASTER_ADDR; MASTER_PORT, default 29500).
#
#   [GPUS=N] [GPUS_PER_NODE=G] [CPUS_PER_TASK=C] [SRUN_ARGS=...] \
#     vitpose_tpu_torch/tools/slurm_train.sh PARTITION JOB_NAME CONFIG \
#       WORK_DIR [PY_ARGS...]
set -x

PARTITION=$1
JOB_NAME=$2
CONFIG=$3
WORK_DIR=$4
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
    python -u -m vitpose_tpu_torch.tools.train ${CONFIG} \
        --work-dir=${WORK_DIR} ${PY_ARGS}
