from .adam import AdamState, adam, cosine_decay_schedule
from .adam_uniform import (AdamUniformState, adam_uniform,
                           cosine_annealing_lr, apply_updates)

__all__ = ["AdamState", "AdamUniformState", "adam", "adam_uniform",
           "cosine_annealing_lr", "cosine_decay_schedule", "apply_updates"]
