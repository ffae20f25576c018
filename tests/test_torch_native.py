"""The port's host topology library (tssplat_torch/native.py,
csrc/topology.cpp) against the JAX package's native library and against
the port's own numpy paths.

At a non-manifold fan edge the (F,3) edge table must name one of the
fan's triangles, and the numpy sort path names another than the hash-table
library does. The JAX package takes its library whenever it loads, so a
port on the numpy path paired a remeshed surface's fan edges otherwise (and
suppressed other antialias pairs) than JAX: the fault shown first below.
Through its own library the port now gives JAX's tables entry for entry.
"""

import numpy as np
import pytest

from tssplat_tpu import native as jax_native
from tssplat_tpu.mesh import surface as jax_surface
from tssplat_tpu.mesh.remesh import tet_remesh_from_surface as jax_remesh
from tssplat_tpu.mesh.spheres import icosphere

from tssplat_torch import native
from tssplat_torch.kernels import build
from tssplat_torch.mesh import surface
from tssplat_torch.mesh.spheres import tet_sphere

# tests/test_native.py:76's fan: three triangles around edge (0,1), and a
# regular neighbour across (1,2)
FAN = np.asarray([[0, 1, 2], [1, 0, 3], [0, 1, 4], [1, 2, 5]], np.int64)
FAN_TETS = np.asarray([[0, 1, 2, 3], [0, 1, 2, 4], [0, 1, 2, 5],
                       [1, 2, 3, 6]], np.int64)


def _fan_slots(faces, edge):
    return [(f, e) for f in range(faces.shape[0]) for e in range(3)
            if {faces[f][e], faces[f][(e + 1) % 3]} == set(edge)]


@pytest.fixture(scope="module")
def remeshed():
    """tests/test_torch_remesh.py's dented sphere remeshed by JAX at its
    edge 0.15 and grid 20: tets whose surface has 4- and 6-triangle fan
    edges."""
    sv, sf = icosphere(subdivisions=3)
    v = sv.copy() * 0.4
    cap = v[:, 2] > 0.28
    v[cap] -= np.asarray([0, 0, 0.25]) * (v[cap, 2:3] / 0.4)
    _, tets = jax_remesh(v, sf, edge_length=0.15, grid_dim=20)
    _, faces = jax_surface.get_surface_vf(tets)
    edges = np.sort(np.concatenate([faces[:, [0, 1]], faces[:, [1, 2]],
                                    faces[:, [2, 0]]]), axis=1)
    _, per_edge = np.unique(edges, axis=0, return_counts=True)
    assert (per_edge > 2).sum() > 10            # non-manifold fan edges
    return tets, faces


def test_numpy_path_pairs_fans_otherwise_than_jax(remeshed):
    """The fault: the port's numpy pairing disagrees with JAX's native
    table at the fan edges (and only there), on the fan and on the
    remeshed surface."""
    want = jax_native.triangle_edge_neighbors(FAN)
    got = surface.triangle_edge_neighbors(FAN, use_native=False)
    fan = _fan_slots(FAN, (0, 1))
    assert any(got[s] != want[s] for s in fan)
    for f in range(4):
        for e in range(3):
            if (f, e) not in fan:
                assert got[f, e] == want[f, e]

    _, faces = remeshed
    want = jax_native.triangle_edge_neighbors(faces)
    got = surface.triangle_edge_neighbors(faces, use_native=False)
    assert (got != want).sum() > 0


def test_fan_matches_jax_native():
    """On the fan: the port's table equals JAX's native one, and
    test_native.py's invariants hold (each fan slot names another fan
    triangle, the regular edge pairs 0 and 3, the rest is open)."""
    out = surface.triangle_edge_neighbors(FAN)
    np.testing.assert_array_equal(out, jax_native.triangle_edge_neighbors(FAN))
    for f in range(4):
        for e in range(3):
            ends = {FAN[f][e], FAN[f][(e + 1) % 3]}
            nb = out[f, e]
            if ends == {0, 1}:
                assert nb >= 0 and nb != f and nb in {0, 1, 2}
            elif ends == {1, 2}:
                assert {nb, f} == {0, 3}
            else:
                assert nb == -1


@pytest.mark.parametrize("what", ["get_surface_vf", "tet_face_neighbors",
                                  "triangle_edge_neighbors"])
@pytest.mark.parametrize("mesh", ["fan", "remeshed"])
def test_equals_jax_native(remeshed, what, mesh):
    """Through the port's library, entry for entry JAX's native output:
    the boundary surface, the tet adjacency in its slot order, and the
    edge table, on the fan and on the remeshed surface."""
    tets, faces = (FAN_TETS, FAN) if mesh == "fan" else remeshed
    if what == "get_surface_vf":
        got = surface.get_surface_vf(tets)
        want = jax_surface.get_surface_vf(tets, use_native=True)
    elif what == "tet_face_neighbors":
        got = surface.tet_face_neighbors(tets)
        want = jax_native.tet_face_neighbors(tets)
    else:
        got = (surface.triangle_edge_neighbors(faces),)
        want = (jax_native.triangle_edge_neighbors(faces),)
    for a, b in zip(got, want):
        assert a.dtype == np.int64
        np.testing.assert_array_equal(a, b)


@pytest.fixture(scope="module")
def ball():
    return tet_sphere(0.05, radius=0.3)


def test_surface_faces_match_numpy(ball):
    """test_native.py's contract, in the port: the library's boundary
    surface equals the numpy path's."""
    _, t = ball
    for a, b in zip(surface.get_surface_vf(t),
                    surface.get_surface_vf(t, use_native=False)):
        np.testing.assert_array_equal(a, b)


def test_tet_face_neighbors_match_numpy(ball):
    """The same degrees and neighbour sets as the numpy path (the slot
    order is the hash table's)."""
    _, t = ball
    nat_n, nat_d = surface.tet_face_neighbors(t)
    ref_n, ref_d = surface.tet_face_neighbors(t, use_native=False)
    np.testing.assert_array_equal(nat_d, ref_d)
    np.testing.assert_array_equal(np.sort(nat_n, axis=1),
                                  np.sort(ref_n, axis=1))


def test_triangle_edge_neighbors_match_numpy(ball):
    """On a manifold surface the two pairings are one table."""
    _, t = ball
    _, faces = surface.get_surface_vf(t)
    np.testing.assert_array_equal(
        surface.triangle_edge_neighbors(faces),
        surface.triangle_edge_neighbors(faces, use_native=False))


@pytest.mark.parametrize("cxx", ["no-such-compiler", "false"])
def test_failed_build_raises(tmp_path, monkeypatch, cxx):
    """A compiler that is missing, or one that fails, raises at first use;
    no numpy path is taken in its place."""
    monkeypatch.setenv("CXX", cxx)
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path)
    native._library.cache_clear()
    try:
        with pytest.raises(RuntimeError, match="compiler|build failed"):
            surface.triangle_edge_neighbors(FAN)
        assert not list(tmp_path.glob("*.so"))
    finally:
        native._library.cache_clear()
