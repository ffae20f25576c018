"""Package boundary of the port: it imports neither JAX nor tssplat_tpu,
its entry points refuse to fall back to the CPU, and its copies of the
host numpy code build what the JAX package builds."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from tssplat_tpu.mesh.spheres import tet_sphere as jax_tet_sphere, icosphere
from tssplat_tpu.mesh.tetmesh import TetMesh as JaxTetMesh
from tssplat_tpu.ops.transform import fibonacci_views as jax_views

from tssplat_torch.mesh.spheres import tet_sphere
from tssplat_torch.mesh.tetmesh import TetMesh
from tssplat_torch.ops.transform import fibonacci_views
from tssplat_torch.geometry import (TetMeshGeometry,
                                    TetMeshMultiSphereGeometry)
from tssplat_torch.tools.synthetic import (render_alpha_of_mesh,
                                           render_views_of_mesh)

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_import_pulls_in_no_jax():
    """Every module of the port, imported in a fresh interpreter, loads no
    jax and no tssplat_tpu module; the driver's, the texture stage's, the
    multi-rank modules, the topology library's binding, the sanitizers,
    the SDS guidance and its driver among them."""
    code = (
        "import sys, pkgutil, importlib, tssplat_torch\n"
        "for m in pkgutil.walk_packages(tssplat_torch.__path__, "
        "'tssplat_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "need = ['tssplat_torch.train', 'tssplat_torch.config', "
        "'tssplat_torch.data', 'tssplat_torch.data.loader', "
        "'tssplat_torch.utils', 'tssplat_torch.utils.checkpoint', "
        "'tssplat_torch.tools.synthetic', 'tssplat_torch.models', "
        "'tssplat_torch.models.networks', 'tssplat_torch.materials', "
        "'tssplat_torch.materials.explicit_material', "
        "'tssplat_torch.materials.exact_stage', "
        "'tssplat_torch.materials.export', 'tssplat_torch.mesh.uv', "
        "'tssplat_torch.parallel', 'tssplat_torch.parallel.mesh', "
        "'tssplat_torch.parallel.spatial', 'tssplat_torch.utils.env', "
        "'tssplat_torch.tools.run_ranks', 'tssplat_torch.native', "
        "'tssplat_torch.utils.debug', 'tssplat_torch.guidance', "
        "'tssplat_torch.guidance.sds', 'tssplat_torch.train_sds']\n"
        "assert all(m in sys.modules for m in need), need\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'tssplat_tpu')]\n"
        "print(len([m for m in sys.modules if m.startswith('tssplat_torch')]))\n"
        "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert int(res.stdout.strip()) >= 22          # the whole package loaded


def test_entry_points_refuse_cpu_fallback(monkeypatch):
    """Without device= the entry points want CUDA and raise when it is
    absent; device='cpu' is the explicit opt-in."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    v, t = tet_sphere(0.2, radius=0.3)
    with pytest.raises(RuntimeError, match="CUDA"):
        TetMeshGeometry(tetmesh=TetMesh(v, t))
    mvp, _, _ = fibonacci_views(1)
    sv, sf = icosphere(1)
    with pytest.raises(RuntimeError, match="CUDA"):
        render_alpha_of_mesh(sv, sf, mvp, 32)
    with pytest.raises(RuntimeError, match="CUDA"):
        render_views_of_mesh(sv, sf, mvp, np.zeros((1, 3)), 32)
    with pytest.raises(RuntimeError, match="CUDA"):
        TetMeshMultiSphereGeometry(dict(key_points_file_path="kp.json"))
    geo = TetMeshGeometry(tetmesh=TetMesh(v, t), device="cpu")
    assert geo.tet_v.device.type == "cpu"


@pytest.mark.parametrize("h", [0.12, 0.2])
def test_mesh_copies_match_jax(h):
    """The port's numpy mesh code builds the JAX package's meshes: same
    tet ball, boundary surface, edge adjacency and tet adjacency."""
    v, t = tet_sphere(h, radius=0.3)
    vj, tj = jax_tet_sphere(h, radius=0.3)
    np.testing.assert_array_equal(v, vj)
    np.testing.assert_array_equal(t, tj)
    m, mj = TetMesh(v, t), JaxTetMesh(vj, tj)
    np.testing.assert_array_equal(m.surface_vid, mj.surface_vid)
    np.testing.assert_array_equal(m.surface_fid, mj.surface_fid)
    np.testing.assert_array_equal(m.surface_edge_neighbors(),
                                  mj.surface_edge_neighbors())
    nb, deg = m.tet_neighbors()
    nbj, degj = mj.tet_neighbors()
    np.testing.assert_array_equal(deg, degj)
    np.testing.assert_array_equal(np.sort(nb, axis=1), np.sort(nbj, axis=1))


def test_views_match_jax():
    for a, b in zip(fibonacci_views(8), jax_views(8)):
        np.testing.assert_array_equal(a, b)


def test_synthetic_alpha_matches_jax():
    """The port's silhouette targets (its own visibility + antialias) equal
    the alpha of the JAX package's render_views_of_mesh. atol 1e-5: the
    clip transforms differ in the last bit (torch.einsum vs XLA's dot),
    which moves the AA crossings by as much."""
    from tssplat_tpu.tools.synthetic import render_views_of_mesh
    sv, sf = icosphere(2)
    sv = sv * np.asarray([0.30, 0.24, 0.18])
    mvp, _, campos = fibonacci_views(2)
    rgba, _, _ = render_views_of_mesh(sv, sf, mvp, campos, 128)
    got = render_alpha_of_mesh(sv, sf, mvp, 128, device="cpu")
    assert got.shape == (2, 128, 128, 1)
    want = rgba[..., 3]
    assert (want > 0).sum() > 500
    diff = np.abs(got[..., 0].numpy() - want)
    # coverage may flip only at a pixel whose centre lies on an edge
    assert (diff > 1e-5).sum() <= 2
    np.testing.assert_allclose(np.sort(diff.ravel())[:-2], 0.0, atol=1e-5)


def test_synthetic_depth_normal_match_jax():
    """The port's depth and normal targets (K1 without rows, the shading
    of the winners, interpolated vertex normals) equal those of the JAX
    package's render_views_of_mesh: depth to 1e-5 (the clip transforms
    differ in the last bit), normals to 1e-4, except at <= 2 pixels whose
    centre lies on an edge."""
    from tssplat_tpu.tools.synthetic import render_views_of_mesh as jax_rv
    sv, sf = icosphere(2)
    sv = sv * np.asarray([0.30, 0.24, 0.18])
    mvp, _, campos = fibonacci_views(2)
    _, d_j, n_j = jax_rv(sv, sf, mvp, campos, 128)
    alpha, d_t, n_t = render_views_of_mesh(sv, sf, mvp, campos, 128,
                                           device="cpu")
    assert alpha.shape == (2, 128, 128, 1)
    assert (d_j > 0).sum() > 500
    dd = np.abs(d_t.numpy() - d_j)
    dn = np.abs(n_t.numpy() - n_j).max(-1)
    assert ((dd > 1e-5) | (dn > 1e-4)).sum() <= 2
