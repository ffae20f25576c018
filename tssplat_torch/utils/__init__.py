from .checkpoint import (latest_checkpoint_step, restore_checkpoint,
                         save_checkpoint)
from .profiling import PrintExecTime, ThroughputMeter, trace_profile
from . import debug

__all__ = ["PrintExecTime", "ThroughputMeter", "debug",
           "latest_checkpoint_step", "restore_checkpoint", "save_checkpoint",
           "trace_profile"]
