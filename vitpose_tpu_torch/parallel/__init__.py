"""Training and evaluation across processes: the process-group bootstrap,
preemption and the seed (distributed.py), the data, expert and model axes
and their collectives (mesh.py), and ZeRO-1 (zero.py)."""
from .distributed import (PreemptionGuard, init_distributed,
                          init_random_seed, is_main_process, rank_and_world)
from .mesh import (Layout, activate, make_mesh, reduce_gradients,
                   shard_params, shard_rows)
from .zero import zero1
