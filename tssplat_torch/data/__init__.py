from .datasets import (ArrayDataset, BlenderImgDataset, MitsubaImgDataset,
                       Wonder3DImgDataset)
from .loader import (ArrayDataLoader, BlenderImgDataLoader,
                     MitsubaImgDataLoader, ViewDataLoader, Wonder3DDataLoader)

__all__ = ["ArrayDataset", "BlenderImgDataset", "MitsubaImgDataset",
           "Wonder3DImgDataset", "ArrayDataLoader", "BlenderImgDataLoader",
           "MitsubaImgDataLoader", "ViewDataLoader", "Wonder3DDataLoader"]
