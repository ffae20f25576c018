from .tet_geometry import (GeometryStatics, GeometryForwardData,
                           LinearInterpolateScheduler, TetMeshGeometry,
                           compute_vertex_normals, geometry_forward,
                           permute_surface_vertices, statics_to)
from .multisphere import TetMeshMultiSphereGeometry, target_edge_length

__all__ = ["GeometryStatics", "GeometryForwardData",
           "LinearInterpolateScheduler", "TetMeshGeometry",
           "TetMeshMultiSphereGeometry", "compute_vertex_normals",
           "geometry_forward", "permute_surface_vertices", "statics_to",
           "target_edge_length"]
