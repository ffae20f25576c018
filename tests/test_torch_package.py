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
from tssplat_tpu.ops.transform import transform_pos as jax_transform_pos

from tssplat_torch.mesh.spheres import tet_sphere
from tssplat_torch.mesh.tetmesh import TetMesh
from tssplat_torch.ops.transform import fibonacci_views, transform_pos
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
    the SDS guidance and its driver and the trace tool among them."""
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
        "'tssplat_torch.guidance.sds', 'tssplat_torch.train_sds', "
        "'tssplat_torch.tools.trace']\n"
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


@pytest.mark.parametrize("is_ortho", [False, True])
def test_transform_pos_is_vec_matches_jax(is_ortho):
    """transform_pos(is_vec=True) takes directions (w = 0: no translation,
    no ortho z division) as JAX's does, and is_vec=False points (w = 1):
    to 1e-6 (torch.einsum against XLA's dot, a last bit apart)."""
    import jax.numpy as jnp
    mvp, _, _ = fibonacci_views(3)
    mvp[:, :3, 3] += [0.5, -0.25, 0.75]               # a translation to drop
    pos = np.random.default_rng(1).normal(size=(40, 3)).astype(np.float32)
    got = {}
    for is_vec in (True, False):
        got[is_vec] = transform_pos(torch.tensor(mvp, dtype=torch.float32),
                                    torch.from_numpy(pos), is_ortho=is_ortho,
                                    is_vec=is_vec).numpy()
        want = np.asarray(jax_transform_pos(
            jnp.asarray(mvp, jnp.float32), jnp.asarray(pos),
            is_ortho=is_ortho, is_vec=is_vec))
        assert got[is_vec].shape == want.shape == (3, 40, 4)
        np.testing.assert_allclose(got[is_vec], want, rtol=1e-6, atol=1e-6)
    # a direction is the MVP's 4x3 block times (x, y, z), undivided
    np.testing.assert_allclose(got[True], np.einsum("vj,bij->bvi", pos,
                                                    mvp[:, :, :3]),
                               rtol=1e-5, atol=1e-5)
    assert np.abs(got[True] - got[False]).max() > 0.1


def test_from_npy_and_save_surface_mesh_match_jax(tmp_path):
    """TetMesh.from_npy reads what save(save_npy=True) writes, and builds
    JAX's mesh from the same files; save_surface_mesh writes JAX's OBJ
    byte for byte, and save() writes the same surface through it."""
    import filecmp
    v, t = tet_sphere(0.2, radius=0.3)
    m = TetMesh(v, t)
    m.update_vtx_pos(v * 1.1)
    m.save(str(tmp_path), "m", save_npy=True)
    got = TetMesh.from_npy(str(tmp_path / "m_vtx.npy"),
                           str(tmp_path / "m_elem.npy"))
    want = JaxTetMesh.from_npy(str(tmp_path / "m_vtx.npy"),
                               str(tmp_path / "m_elem.npy"))
    for a, b in ((got.vtx_init, v * 1.1), (got.elem, t),
                 (got.vtx_init, want.vtx_init), (got.elem, want.elem),
                 (got.surface_vid, want.surface_vid),
                 (got.surface_fid, want.surface_fid)):
        np.testing.assert_array_equal(a, b)
    mj = JaxTetMesh(v, t)
    mj.update_vtx_pos(v * 1.1)
    m.save_surface_mesh(str(tmp_path / "t"))
    mj.save_surface_mesh(str(tmp_path / "j"))
    m.save_surface_mesh(str(tmp_path / "t"), "named.obj")
    assert filecmp.cmp(tmp_path / "t" / "surface_mesh.obj",
                       tmp_path / "j" / "surface_mesh.obj", shallow=False)
    assert filecmp.cmp(tmp_path / "t" / "named.obj",
                       tmp_path / "m_surface_mesh.obj", shallow=False)


def test_ops_and_utils_export_the_jax_names():
    """tssplat_torch.ops exports a counterpart of every name of
    tssplat_tpu.ops but rasterize_ids_tiled (none by design), plus
    antialias_color and visibility_ids; tssplat_torch.utils the rank
    functions. In a fresh interpreter the imports load no JAX and build
    or load no kernel library; the rasterize submodule stays reachable."""
    import tssplat_tpu.ops as jax_ops
    code = (
        "import importlib, sys\n"
        "from tssplat_torch.ops import (rasterize, interpolate, antialias,\n"
        "    transform_pos, signed_distance)\n"
        "from tssplat_torch.utils import (get_rank, get_world_size,\n"
        "    init_distributed)\n"
        "import tssplat_torch.ops as ops\n"
        "from tssplat_torch.ops.rasterize import antialias_rows\n"
        "from tssplat_torch.kernels import build\n"
        "mod = importlib.import_module('tssplat_torch.ops.rasterize')\n"
        "assert mod.rasterize is rasterize and ops.rasterize is rasterize\n"
        "assert build._library.cache_info().currsize == 0\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'tssplat_tpu', 'triton')]\n"
        "assert not bad, bad\n"
        "print(' '.join(ops.__all__))\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    names = set(res.stdout.split())
    assert names == (set(jax_ops.__all__) - {"rasterize_ids_tiled"}) | {
        "antialias_color", "visibility_ids"}
    import tssplat_torch.ops as ops
    import tssplat_torch.utils as utils
    assert all(callable(getattr(ops, n)) for n in names)
    assert {"get_rank", "get_world_size", "init_distributed"} <= set(
        utils.__all__)


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
    rgba, d_t, n_t = render_views_of_mesh(sv, sf, mvp, campos, 128,
                                          device="cpu")
    assert rgba.shape == (2, 128, 128, 4)
    assert (d_j > 0).sum() > 500
    dd = np.abs(d_t - d_j)
    dn = np.abs(n_t - n_j).max(-1)
    assert ((dd > 1e-5) | (dn > 1e-4)).sum() <= 2
