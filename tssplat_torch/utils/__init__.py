from .checkpoint import (latest_checkpoint_step, restore_checkpoint,
                         save_checkpoint)
from .env import get_rank, get_world_size, init_distributed
from .profiling import PrintExecTime, ThroughputMeter, trace_profile
from . import debug

__all__ = ["PrintExecTime", "ThroughputMeter", "debug", "get_rank",
           "get_world_size", "init_distributed", "latest_checkpoint_step",
           "restore_checkpoint", "save_checkpoint", "trace_profile"]
