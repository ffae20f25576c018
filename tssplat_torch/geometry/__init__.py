from .tet_geometry import (GeometryStatics, GeometryForwardData,
                           LinearInterpolateScheduler, TetMeshGeometry,
                           compute_vertex_normals,
                           compute_vertex_tangents, geometry_forward,
                           permute_surface_vertices, statics_to)
from .multisphere import (TetMeshMultiSphereGeometry, TetMeshSkeletonGeometry,
                          target_edge_length)

__all__ = ["GeometryStatics", "GeometryForwardData",
           "LinearInterpolateScheduler", "TetMeshGeometry",
           "TetMeshMultiSphereGeometry", "TetMeshSkeletonGeometry",
           "compute_vertex_normals",
           "compute_vertex_tangents",
           "geometry_forward", "permute_surface_vertices", "statics_to",
           "target_edge_length"]
