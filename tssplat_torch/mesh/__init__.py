from .io import load_veg, save_veg, load_obj, save_obj, save_mtl
from .spheres import icosphere, load_template_sphere, tet_capsule, tet_sphere
from .surface import get_surface_vf, triangle_edge_neighbors, tet_face_neighbors
from .tetmesh import TetMesh, trivial_uv_atlas
from .uv import chart_uv_atlas

__all__ = ["load_veg", "save_veg", "load_obj", "save_obj", "save_mtl",
           "icosphere", "tet_sphere", "tet_capsule", "load_template_sphere",
           "get_surface_vf",
           "triangle_edge_neighbors", "tet_face_neighbors", "TetMesh",
           "trivial_uv_atlas", "chart_uv_atlas"]
