from .tet_geometry import (GeometryStatics, GeometryForwardData,
                           TetMeshGeometry, compute_vertex_normals,
                           geometry_forward, statics_to)
from .multisphere import TetMeshMultiSphereGeometry, target_edge_length

__all__ = ["GeometryStatics", "GeometryForwardData", "TetMeshGeometry",
           "TetMeshMultiSphereGeometry", "compute_vertex_normals",
           "geometry_forward", "statics_to", "target_edge_length"]
