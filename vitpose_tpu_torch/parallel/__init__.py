"""Process-level concerns of training: preemption and the seed. Multi-GPU
training is not ported yet (ROADMAP.md queue 1 item 11)."""
from .distributed import PreemptionGuard, init_random_seed
