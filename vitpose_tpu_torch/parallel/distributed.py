"""Process-group bootstrap, graceful preemption and the training seed.

Counterpart of vitpose_tpu/parallel/distributed.py (`init_distributed`,
`PreemptionGuard`, `init_random_seed`). One process per card, as
torch.distributed has it: `init_distributed` reads the launcher's
environment and starts the default process group (NCCL on the card, gloo on
the CPU); `parallel/mesh.py` lays the data, expert and model axes over it.

Three launch contracts are read, in this order:

  * torchrun (`python -m torch.distributed.run`): RANK, WORLD_SIZE,
    LOCAL_RANK, MASTER_ADDR, MASTER_PORT;
  * the JAX package's own: COORDINATOR_ADDRESS (host:port), NUM_PROCESSES,
    PROCESS_ID (LOCAL_RANK where set, else the rank modulo the cards);
  * SLURM (`srun`): SLURM_PROCID, SLURM_NTASKS, SLURM_LOCALID, the master
    at MASTER_ADDR or the first host of SLURM_JOB_NODELIST, port
    MASTER_PORT or 29500.

A world of one is a no-op. A rendezvous that fails raises: a process never
trains alone because its peers did not come.
"""
from __future__ import annotations

import datetime
import os
import re
import signal
from typing import Callable, Optional

import numpy as np
import torch
import torch.distributed as dist

# every process group's limit on one collective (torch's own default for
# NCCL is 10 minutes, for gloo 30); init_distributed's `timeout` replaces
# it for the groups that parallel/mesh.py builds
DEFAULT_TIMEOUT = datetime.timedelta(minutes=10)
_timeout = DEFAULT_TIMEOUT


def group_timeout() -> datetime.timedelta:
    """The limit on one collective that the running group was started
    with."""
    return _timeout


def _first_slurm_host(nodelist: str) -> str:
    """The first host of a SLURM node list: 'gpu[03-05,07],cpu1' -> 'gpu03'
    (what `scontrol show hostnames | head -n1` prints)."""
    m = re.match(r'([^,\[]+)(\[([^\]]+)\])?', nodelist)
    if m is None:
        raise ValueError(f'SLURM_JOB_NODELIST {nodelist!r}: no host')
    if not m.group(2):
        return m.group(1)
    first = m.group(3).split(',')[0].split('-')[0]
    return m.group(1) + first


def cluster_env(environ=None) -> Optional[dict]:
    """The launch contract found in `environ` (default os.environ):
    {'rank', 'world', 'local_rank', 'init_method', 'source'}, or None when
    it describes a single process. A contract that names several processes
    but lacks a field raises KeyError."""
    env = os.environ if environ is None else environ
    if 'RANK' in env and 'WORLD_SIZE' in env:
        world = int(env['WORLD_SIZE'])
        if world <= 1:
            return None
        rank = int(env['RANK'])
        return dict(rank=rank, world=world,
                    local_rank=int(env.get('LOCAL_RANK', rank)),
                    init_method=(f"tcp://{env['MASTER_ADDR']}:"
                                 f"{env['MASTER_PORT']}"),
                    source='torchrun')
    if env.get('COORDINATOR_ADDRESS') and int(env.get('NUM_PROCESSES', 0)
                                              or 0) > 1:
        rank = int(env['PROCESS_ID'])
        n_cards = max(torch.cuda.device_count(), 1)
        return dict(rank=rank, world=int(env['NUM_PROCESSES']),
                    local_rank=int(env.get('LOCAL_RANK', rank % n_cards)),
                    init_method=f"tcp://{env['COORDINATOR_ADDRESS']}",
                    source='coordinator')
    if int(env.get('SLURM_NTASKS', '1') or 1) > 1:
        addr = env.get('MASTER_ADDR') or _first_slurm_host(
            env['SLURM_JOB_NODELIST'])
        return dict(rank=int(env['SLURM_PROCID']),
                    world=int(env['SLURM_NTASKS']),
                    local_rank=int(env['SLURM_LOCALID']),
                    init_method=f"tcp://{addr}:"
                                f"{env.get('MASTER_PORT', '29500')}",
                    source='slurm')
    return None


def init_distributed(device='cuda', backend: Optional[str] = None,
                     timeout: datetime.timedelta = DEFAULT_TIMEOUT,
                     init_method: Optional[str] = None,
                     rank: Optional[int] = None,
                     world_size: Optional[int] = None):
    """Start the default process group from the launcher's environment
    (see the module docstring), or from `init_method`, `rank` and
    `world_size` where the caller gives them (then also a group of one).
    Returns (rank, world size); (0, 1) where the environment names no
    group of several processes. Idempotent: a second call returns the
    running group's.

    The backend is NCCL when `device` is CUDA and gloo on the CPU, unless
    `backend` names one; on CUDA the process's card becomes
    cuda:LOCAL_RANK (modulo the cards it sees). Every collective of the
    group fails after `timeout`.
    """
    if dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    if init_method is not None:
        found = dict(rank=int(rank), world=int(world_size),
                     local_rank=int(rank), init_method=init_method)
    else:
        found = cluster_env()
    if found is None or (found['world'] <= 1 and init_method is None):
        return 0, 1
    global _timeout
    _timeout = timeout
    cuda = torch.device(device).type == 'cuda'
    if cuda:
        # modulo the cards this process sees (a launcher may show each
        # process its own card only)
        torch.cuda.set_device(found['local_rank']
                              % max(torch.cuda.device_count(), 1))
    dist.init_process_group(backend or ('nccl' if cuda else 'gloo'),
                            init_method=found['init_method'],
                            rank=found['rank'],
                            world_size=found['world'], timeout=timeout)
    return dist.get_rank(), dist.get_world_size()


def rank_and_world():
    """(rank, world size) of the default group, (0, 1) without one."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def is_main_process() -> bool:
    """Whether this process writes logs and checkpoints (rank 0)."""
    return rank_and_world()[0] == 0


def barrier():
    """Wait for every process of the default group (no-op alone)."""
    if rank_and_world()[1] > 1:
        dist.barrier()


class PreemptionGuard:
    """A SIGTERM handler that asks the training loop for a final checkpoint.

    The loop checks `should_stop` after each step; on preemption it saves
    and returns instead of dying mid-step. `install` must run in the main
    thread (Python's rule for signal handlers); `uninstall` puts the
    previous handler back.
    """

    def __init__(self, on_preempt: Optional[Callable] = None):
        self.should_stop = False
        self._on_preempt = on_preempt
        self._prev = None

    def install(self):
        def handler(signum, frame):
            self.should_stop = True
            if self._on_preempt is not None:
                self._on_preempt()
            if callable(self._prev):
                self._prev(signum, frame)
        self._prev = signal.signal(signal.SIGTERM, handler)
        return self

    def uninstall(self):
        signal.signal(signal.SIGTERM,
                      signal.SIG_DFL if self._prev is None else self._prev)


def init_random_seed(seed: Optional[int] = None) -> int:
    """The training seed: `seed` where given, else a random one drawn on
    rank 0 and broadcast to every process (reference apis/train.py:27
    `init_random_seed`, JAX's :75-88)."""
    if seed is not None:
        return int(seed)
    seed = int(np.random.randint(2 ** 31))
    if rank_and_world()[1] > 1:
        nccl = dist.get_backend() == 'nccl'
        t = torch.tensor([seed], dtype=torch.int64,
                         device='cuda' if nccl else 'cpu')
        dist.broadcast(t, src=0)
        seed = int(t.item())
    return seed
