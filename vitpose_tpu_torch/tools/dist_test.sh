#!/usr/bin/env bash
# Multi-process evaluation launcher of the port (counterpart of the JAX
# package's tools/dist_test.sh): one process per card through torchrun, as
# tools/dist_train.sh launches training; each rank evaluates its shard of
# the val set and rank 0 scores the gathered results.
#
#   [NPROC=N] [PORT=P] vitpose_tpu_torch/tools/dist_test.sh CONFIG CKPT \
#       [ARGS...]
#
# ARGS go to `python -m vitpose_tpu_torch.tools.test` (e.g. --out
# stats.json, --tmpdir DIR, --device cpu). With NPROC 1 (the default) the
# evaluation CLI runs directly.
set -euo pipefail
CONFIG=$1
CHECKPOINT=$2
shift 2
NPROC=${NPROC:-1}
PORT=${PORT:-$((29400 + RANDOM % 1000))}
ROOT="$(cd "$(dirname "$0")/../.." && pwd)"
export PYTHONPATH="$ROOT${PYTHONPATH:+:$PYTHONPATH}"
if [ "$NPROC" -le 1 ]; then
    exec python -m vitpose_tpu_torch.tools.test "$CONFIG" "$CHECKPOINT" "$@"
fi
exec torchrun --nproc_per_node="$NPROC" --master_addr=127.0.0.1 \
    --master_port="$PORT" -m vitpose_tpu_torch.tools.test "$CONFIG" \
    "$CHECKPOINT" "$@"
