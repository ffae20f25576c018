from .checkpoint import (latest_checkpoint_step, restore_checkpoint,
                         save_checkpoint)
from .profiling import ThroughputMeter

__all__ = ["ThroughputMeter", "latest_checkpoint_step", "restore_checkpoint",
           "save_checkpoint"]
