from .adam_uniform import (AdamUniformState, adam_uniform,
                           cosine_annealing_lr, apply_updates)

__all__ = ["AdamUniformState", "adam_uniform", "cosine_annealing_lr",
           "apply_updates"]
