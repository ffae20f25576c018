from .checkpoint import (latest_checkpoint_step, restore_checkpoint,
                         save_checkpoint)
from .env import get_rank, get_world_size, init_distributed
from .profiling import ThroughputMeter, span, trace_profile
from . import debug

__all__ = ["ThroughputMeter", "debug", "get_rank", "get_world_size",
           "init_distributed", "latest_checkpoint_step",
           "restore_checkpoint", "save_checkpoint", "span", "trace_profile"]
