#!/usr/bin/env bash
# Multi-process training launcher of the port (counterpart of the JAX
# package's tools/dist_train.sh and the reference's, which wraps
# torch.distributed.launch): one process per card through torchrun, whose
# RANK / WORLD_SIZE / MASTER_ADDR / MASTER_PORT environment
# parallel/distributed.py's init_distributed reads.
#
#   [NPROC=N] [PORT=P] vitpose_tpu_torch/tools/dist_train.sh CONFIG [ARGS...]
#
# ARGS go to `python -m vitpose_tpu_torch.tools.train` (e.g. --work-dir
# DIR, --device cpu for gloo ranks on the CPU). With NPROC 1 (the default)
# the training CLI runs directly. JAX's COORDINATOR_ADDRESS contract is not
# set here: torchrun's is the one the ranks read.
set -euo pipefail
CONFIG=$1
shift
NPROC=${NPROC:-1}
PORT=${PORT:-$((29400 + RANDOM % 1000))}
ROOT="$(cd "$(dirname "$0")/../.." && pwd)"
export PYTHONPATH="$ROOT${PYTHONPATH:+:$PYTHONPATH}"
if [ "$NPROC" -le 1 ]; then
    exec python -m vitpose_tpu_torch.tools.train "$CONFIG" "$@"
fi
exec torchrun --nproc_per_node="$NPROC" --master_addr=127.0.0.1 \
    --master_port="$PORT" -m vitpose_tpu_torch.tools.train "$CONFIG" "$@"
