"""Camera and clip-space transforms (port of ``tssplat_tpu/ops/transform.py``).

``transform_pos`` is torch; ``look_at``, ``perspective`` and
``fibonacci_views`` are host numpy, copied so both packages build the same
cameras: row-vector points times MVP^T, the reference's y-flipped
perspective, golden-spiral views at radius 4, fov 39.3077°, near 1e-3,
far 10 (reference renderers/mesh_rasterizer.py:57-79,
data/render_dataset.py:25-146). Row 0 of a rendered image is NDC y = -1.
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np
import torch

DEFAULT_FOV = 39.3077
DEFAULT_NEAR = 1e-3
DEFAULT_FAR = 10.0


def transform_pos(mvp: torch.Tensor, pos: torch.Tensor,
                  is_ortho: bool = False, ortho_z_div: float = 6.0,
                  is_vec: bool = False) -> torch.Tensor:
    """World positions (V,3) -> clip space (B,V,4) for MVPs (B,4,4),
    including the reference's orthographic z/6. ``is_vec`` transforms
    directions (w = 0: no translation, and no ortho z division)."""
    w = torch.zeros_like(pos[..., :1]) if is_vec else \
        torch.ones_like(pos[..., :1])
    posw = torch.cat([pos, w], dim=-1)                               # (V,4)
    res = torch.einsum("vj,bij->bvi", posw, mvp)
    if is_ortho and not is_vec:
        res = torch.cat([res[..., :2], res[..., 2:3] / ortho_z_div,
                         res[..., 3:]], dim=-1)
    return res


def look_at(eye, center, up) -> np.ndarray:
    eye = np.asarray(eye, dtype=np.float64)
    center = np.asarray(center, dtype=np.float64)
    up = np.asarray(up, dtype=np.float64)
    fwd = (center - eye) / np.linalg.norm(center - eye)
    right = np.cross(fwd, up)
    right /= np.linalg.norm(right)
    up2 = np.cross(right, fwd)
    up2 /= np.linalg.norm(up2)
    M = np.eye(4)
    M[0, :3], M[1, :3], M[2, :3] = right, up2, -fwd
    M[0, 3] = -right @ eye
    M[1, 3] = -up2 @ eye
    M[2, 3] = fwd @ eye
    return M


def perspective(fov_deg: float = DEFAULT_FOV, aspect: float = 1.0,
                near: float = DEFAULT_NEAR, far: float = DEFAULT_FAR) -> np.ndarray:
    t = math.tan(math.radians(fov_deg) * 0.5)
    M = np.zeros((4, 4))
    M[0, 0] = 1.0 / (aspect * t)
    M[1, 1] = -1.0 / t                       # y flip, as in the reference
    M[2, 2] = -(far + near) / (far - near)
    M[2, 3] = -(2 * far * near) / (far - near)
    M[3, 2] = -1.0
    return M


def fibonacci_views(n: int, radius: float = 4.0, fov_deg: float = DEFAULT_FOV,
                    near: float = DEFAULT_NEAR, far: float = DEFAULT_FAR
                    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Golden-spiral camera ring: (mvp (n,4,4), mv (n,4,4), campos (n,3))."""
    golden = (1 + 5 ** 0.5) / 2
    i = np.arange(n)
    theta = 2 * math.pi * i / golden
    phi = np.arccos(1 - 2 * i / n)
    xyz = np.stack([np.cos(theta) * np.sin(phi), np.sin(theta) * np.sin(phi),
                    np.cos(phi)], axis=1) * radius
    P = perspective(fov_deg, 1.0, near, far)
    mvps, mvs = [], []
    for eye in xyz:
        d = eye / np.linalg.norm(eye)
        up = np.asarray([0.0, 0.0, 1.0])
        if abs(up @ d) > math.cos(math.pi / 8.0):
            up = np.asarray([0.0, 1.0, 0.0])
        V = look_at(eye, np.zeros(3), up)
        mvs.append(V)
        mvps.append(P @ V)
    return np.stack(mvps), np.stack(mvs), xyz
