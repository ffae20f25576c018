from .tet_geometry import (GeometryStatics, GeometryForwardData,
                           TetMeshGeometry, geometry_forward)

__all__ = ["GeometryStatics", "GeometryForwardData", "TetMeshGeometry",
           "geometry_forward"]
