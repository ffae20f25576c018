from .sds import (DiffusersGuidance, SDSConfig, TargetImageGuidance,
                  load_guidance, sds_image_grad)

__all__ = ["SDSConfig", "TargetImageGuidance", "DiffusersGuidance",
           "sds_image_grad", "load_guidance"]
