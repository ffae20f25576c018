from .datasets import ArrayDataset, BlenderImgDataset, MitsubaImgDataset
from .loader import (ArrayDataLoader, BlenderImgDataLoader,
                     MitsubaImgDataLoader, ViewDataLoader)

__all__ = ["ArrayDataset", "BlenderImgDataset", "MitsubaImgDataset",
           "ArrayDataLoader", "BlenderImgDataLoader", "MitsubaImgDataLoader",
           "ViewDataLoader"]
