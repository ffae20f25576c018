"""Textured OBJ export: bake the fitted colour field into a texture over
the surface's UV atlas and write obj + mtl + png (port of
``tssplat_tpu/materials/export.py``; reference
renderers/mesh_rasterizer.py:165-241).
"""

from __future__ import annotations

import os

import cv2
import numpy as np
import torch
from PIL import Image

from ..mesh.io import save_mtl, save_obj
from ..ops.rasterize import interpolate, rasterize
from ..render.pipeline import _apply_material_chunked


@torch.no_grad()
def export_textured_obj(geometry, material, path: str, folder: str,
                        texture_res: int = 1024,
                        step: int = 1 << 30) -> None:
    """Write ``<path>/<folder>/{texture_kd.png, material.mtl, mesh.obj}``.

    The UV layout is rasterized as one view at texture_res² by the port's
    ``rasterize`` (binning + K1 or K2a on the card), the UV vertices' clip
    coordinates (2u-1, 2v-1, 0, 1) expanded to the corner layout; every z
    is 0, so the smaller face id takes every shared edge. Each texel's
    world position is interpolated from the UV vertices' surface vertices,
    the material is evaluated there at ``step`` (progressive encodings
    mask levels by step; the default unlocks every level), the texels no
    face covers are inpainted (OpenCV TELEA, radius 2) and the image is
    flipped, since OBJ's v origin is the bottom row."""
    out_dir = os.path.join(path, folder)
    os.makedirs(out_dir, exist_ok=True)
    dev = geometry.tet_v.device

    tetmesh = geometry.tetmesh
    v_pos = geometry.tet_v.detach().cpu().numpy()[tetmesh.surface_vid]
    faces = np.asarray(tetmesh.surface_fid)
    uv, uv_faces, uv_vid = tetmesh.uv_atlas()

    corner = np.asarray(uv_faces, np.int64).reshape(-1)
    uv_clip = np.concatenate([uv * 2.0 - 1.0, np.zeros_like(uv[:, :1]),
                              np.ones_like(uv[:, :1])], axis=1)
    pos_clip = torch.as_tensor(uv_clip[corner], dtype=torch.float32,
                               device=dev)[None]
    rast, _ = rasterize(pos_clip, (texture_res, texture_res))
    attr = torch.as_tensor(v_pos[uv_vid][corner], dtype=torch.float32,
                           device=dev)
    gb_pos = interpolate(attr, rast)[0]                    # (T,T,3)

    # every texel, as JAX evaluates them: TELEA's result near the covered
    # region reads the values under its mask too
    color = _apply_material_chunked(material.apply_fn, material.params,
                                    gb_pos, step).cpu().numpy()
    mask = (rast[0, ..., 3] > 0).cpu().numpy()

    img = np.clip(color * 255.0, 0, 255).astype(np.uint8)
    img = cv2.inpaint(img, (~mask).astype(np.uint8) * 255, 2,
                      cv2.INPAINT_TELEA)
    tex_name = "texture_kd.png"
    Image.fromarray(img).transpose(Image.FLIP_TOP_BOTTOM).save(
        os.path.join(out_dir, tex_name))

    save_mtl(os.path.join(out_dir, "material.mtl"), "material",
             texture_maps={"map_Kd": tex_name})
    save_obj(os.path.join(out_dir, "mesh.obj"), v_pos, faces,
             uvs=uv, uv_faces=uv_faces, mtllib="material.mtl",
             matname="material")
