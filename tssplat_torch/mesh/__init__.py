from .io import load_veg, save_veg, load_obj, save_obj
from .spheres import icosphere, tet_sphere
from .surface import get_surface_vf, triangle_edge_neighbors, tet_face_neighbors
from .tetmesh import TetMesh

__all__ = ["load_veg", "save_veg", "load_obj", "save_obj", "icosphere",
           "tet_sphere", "get_surface_vf", "triangle_edge_neighbors",
           "tet_face_neighbors", "TetMesh"]
