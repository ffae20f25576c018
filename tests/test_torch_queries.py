"""The port's mesh queries, voxel meshing and metrics against the JAX
package's (``tssplat_torch.ops.queries``, ``tools/voxel_mesh.py``,
``tools/metrics.py``), on the CPU, from the same numpy inputs.

XLA:CPU contracts multiply-adds into FMAs, differently in each fused
program, where PyTorch rounds every product: the two agree to f32
rounding, not bit for bit. So hit and miss may differ on rays within 1e-5
(barycentric) of an edge, the triangle id where the two nearest hits lie
within 1e-5, and the sign of a distance where the nearest triangles tie
(within 1e-5 of d², f64) and disagree on it (at a concave vertex or edge
the nearest-face sign rule is decided by rounding); each such case is
counted and checked in float64 here.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tssplat_tpu.mesh.spheres import icosphere
from tssplat_tpu.ops import queries as jq
from tssplat_tpu.tools import metrics as jm
from tssplat_tpu.tools import voxel_mesh as jv

from tssplat_torch.ops import queries as tq
from tssplat_torch.tools import metrics as tm
from tssplat_torch.tools import voxel_mesh as tv

torch.set_num_threads(1)


def _dumbbell():
    sv, sf = icosphere(3)
    v = np.concatenate([sv * 0.3 + [-0.45, 0, 0], sv * 0.3 + [0.45, 0, 0]])
    return v, np.concatenate([sf, sf + sv.shape[0]])


def _dented():
    """tests/test_remesh.py's nonconvex scene: a sphere of radius 0.4 with
    its cap pulled in."""
    sv, sf = icosphere(3)
    v = sv * 0.4
    cap = v[:, 2] > 0.28
    v[cap] -= np.asarray([0, 0, 0.25]) * (v[cap, 2:3] / 0.4)
    return v, sf


SCENES = {"icosphere": lambda: icosphere(3), "dumbbell": _dumbbell,
          "dented": _dented}


def _jax_hit_full(o, d, v, f):
    return [np.asarray(x) for x in jq.ray_mesh_hit_full(
        jnp.asarray(o), jnp.asarray(d), jnp.asarray(v, jnp.float32),
        jnp.asarray(f, jnp.int32))]


def _rays(rng, n):
    """Half the rays from inside the scene's box in any direction, half
    from a sphere of radius 2 aimed at the box."""
    o1 = rng.uniform(-0.6, 0.6, size=(n, 3))
    d1 = rng.normal(size=(n, 3))
    o2 = rng.normal(size=(n, 3))
    o2 = 2.0 * o2 / np.linalg.norm(o2, axis=1, keepdims=True)
    d2 = rng.uniform(-0.6, 0.6, size=(n, 3)) - o2
    o, d = np.concatenate([o1, o2]), np.concatenate([d1, d2])
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return o.astype(np.float32), d.astype(np.float32)


def _f64_hits(o, d, v, f):
    """(t (R,F) with inf off the triangle, u, v) of every ray against every
    triangle in float64, Möller–Trumbore without tolerances."""
    o, d = o.astype(np.float64), d.astype(np.float64)
    tri = v.astype(np.float64)[f]
    v0, e1, e2 = tri[:, 0], tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0]
    p = np.cross(d[:, None], e2[None])
    det = np.sum(e1[None] * p, -1)
    inv = 1.0 / np.where(det == 0, 1.0, det)
    s = o[:, None] - v0[None]
    u = np.sum(s * p, -1) * inv
    q = np.cross(s, e1[None])
    w = np.sum(d[:, None] * q, -1) * inv
    t = np.sum(e2[None] * q, -1) * inv
    ok = (det != 0) & (u >= 0) & (w >= 0) & (u + w <= 1) & (t > 0)
    return np.where(ok, t, np.inf), u, w


@pytest.mark.parametrize("scene", ["icosphere", "dumbbell", "dented"])
def test_ray_hits_match_jax(scene):
    """ray_mesh_hit_full and ray_mesh_first_hit against JAX on 4,000 seeded
    rays: hit and miss agree but on rays within 1e-5 (barycentric, f64) of
    an edge, t to rtol 1e-5, u and v to 1e-4, the triangle id wherever the
    two nearest f64 hits differ by more than 1e-5."""
    v, f = SCENES[scene]()
    o, d = _rays(np.random.default_rng(0), 2000)
    jt, jid, ju, jv_ = _jax_hit_full(o, d, v, f)
    args = (torch.tensor(o), torch.tensor(d),
            torch.tensor(v, dtype=torch.float32), torch.tensor(f))
    tt, tid, tu, tv_ = (x.numpy() for x in tq.ray_mesh_hit_full(*args))
    assert np.array_equal(tq.ray_mesh_first_hit(*args).numpy(), tt)
    np.testing.assert_array_equal(
        np.asarray(jq.ray_mesh_first_hit(jnp.asarray(o), jnp.asarray(d),
                                         jnp.asarray(v, jnp.float32),
                                         jnp.asarray(f, jnp.int32))), jt)

    n_hit = int(np.isfinite(jt).sum())
    assert n_hit > 1000
    differ = np.isfinite(jt) != np.isfinite(tt)
    for r in np.nonzero(differ)[0]:
        k = jid[r] if jid[r] >= 0 else tid[r]
        _, u, w = _f64_hits(o[r:r + 1], d[r:r + 1], v, f[k:k + 1])
        assert abs(min(u[0, 0], w[0, 0], 1 - u[0, 0] - w[0, 0])) < 1e-5, r
    both = np.isfinite(jt) & np.isfinite(tt)
    np.testing.assert_allclose(tt[both], jt[both], rtol=1e-5)
    id_differ = both & (jid != tid)
    if id_differ.any():
        t64 = np.sort(_f64_hits(o[id_differ], d[id_differ], v, f)[0], axis=1)
        assert np.all(t64[:, 1] - t64[:, 0] <= 1e-5)
    same = both & (jid == tid)
    np.testing.assert_allclose(tu[same], ju[same], atol=1e-4)
    np.testing.assert_allclose(tv_[same], jv_[same], atol=1e-4)
    miss = ~np.isfinite(tt)
    assert np.all(tid[miss] == -1) and np.all(tu[miss] == 0)
    print(f"{scene}: {n_hit} hits, {int(differ.sum())} hit/miss near an "
          f"edge, {int(id_differ.sum())} id near-ties")


def _sign_ties(p, v, f):
    """(n,) bool: among the triangles within 1e-5 (relative) of the
    nearest d² (the port's closest-point rule in float64), some signs are
    + and some -."""
    p64 = torch.tensor(p, dtype=torch.float64)
    tri = torch.tensor(v, dtype=torch.float64)[torch.tensor(f)]
    v0, e1, e2 = tri[:, 0], tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0]
    planes = [tuple(x[:, k].unsqueeze(0) for k in range(3))
              for x in (v0, e1, e2)]
    d2, cp = tq._point_tri_closest(
        tuple(p64[:, k].unsqueeze(1) for k in range(3)), *planes, True)
    nrm = torch.linalg.cross(e1, e2)
    dot = sum((p64[:, k:k + 1] - cp[k]) * nrm[None, :, k] for k in range(3))
    near = d2 <= d2.amin(1, keepdim=True) * (1 + 1e-5) + 1e-14
    return ((near & (dot > 0)).any(1) & (near & (dot < 0)).any(1)).numpy()


@pytest.mark.parametrize("scene", ["icosphere", "dumbbell", "dented"])
def test_signed_distance_matches_jax(scene):
    """signed_distance against JAX on 3,000 seeded points: |sd| to 1e-5
    everywhere; sd to 1e-5 and its sign wherever |sd| > 1e-4, except at
    points whose nearest triangles tie with both signs (f64), which must
    stay under 1% of the points (none on the convex scenes)."""
    v, f = SCENES[scene]()
    p = np.random.default_rng(1).uniform(-0.9, 0.9, size=(3000, 3)) \
        .astype(np.float32)
    js = np.asarray(jq.signed_distance(jnp.asarray(p),
                                       jnp.asarray(v, jnp.float32),
                                       jnp.asarray(f, jnp.int32)))
    ts = tq.signed_distance(torch.tensor(p),
                            torch.tensor(v, dtype=torch.float32),
                            torch.tensor(f)).numpy()
    np.testing.assert_allclose(np.abs(ts), np.abs(js), atol=1e-5, rtol=0)
    flip = (np.sign(ts) != np.sign(js)) & (np.abs(js) > 1e-4)
    assert np.all(_sign_ties(p[flip], v, f)), np.nonzero(flip)[0]
    assert flip.sum() <= 0.01 * p.shape[0]
    if scene != "dented":
        assert flip.sum() == 0
    keep = ~flip & (np.abs(js) > 1e-4)
    np.testing.assert_allclose(ts[keep], js[keep], atol=1e-5, rtol=0)
    print(f"{scene}: {int(flip.sum())} sign ties of {p.shape[0]} points")


def test_surface_nets_and_smoothing_bit_equal():
    """surface_nets and laplacian_smooth equal JAX's bit for bit on a
    ragged occupancy (a ball with 3% of its cells flipped)."""
    rng = np.random.default_rng(2)
    n = 20
    lin = np.linspace(-1.2, 1.2, n)
    g = np.stack(np.meshgrid(lin, lin, lin, indexing="ij"), axis=-1)
    occ = (np.linalg.norm(g, axis=-1) < 0.9) ^ (rng.uniform(size=(n,) * 3)
                                                < 0.03)
    jv_, jf = jv.surface_nets(occ, (-1.2,) * 3, 2.4 / (n - 1))
    tv_, tf = tv.surface_nets(occ, (-1.2,) * 3, 2.4 / (n - 1))
    assert jf.shape[0] > 500
    assert np.array_equal(jv_, tv_) and np.array_equal(jf, tf)
    assert np.array_equal(jv.laplacian_smooth(jv_, jf, 6),
                          tv.laplacian_smooth(tv_, tf, 6))


def test_sdf_files_bit_equal(tmp_path):
    """save_sdf writes JAX's bytes, and load_sdf reads JAX's file."""
    sdf = np.random.default_rng(3).normal(size=(9, 9, 9)).astype(np.float32)
    jv.save_sdf(str(tmp_path / "j.sdf"), sdf, [-1.2] * 3, [1.2] * 3)
    tv.save_sdf(str(tmp_path / "t.sdf"), sdf, [-1.2] * 3, [1.2] * 3)
    assert (tmp_path / "j.sdf").read_bytes() == (tmp_path / "t.sdf") \
        .read_bytes()
    s2, lo, hi = tv.load_sdf(str(tmp_path / "j.sdf"))
    assert np.array_equal(s2, sdf)
    assert np.array_equal(lo, [-1.2] * 3) and np.array_equal(hi, [1.2] * 3)


def test_metrics_match_jax():
    """sample_surface bit-equal; mesh_chamfer to rtol 1e-5 (f32 means);
    volume_iou and silhouette_iou within 2e-3 of JAX's (a few grid points at
    sign ties, a few pixels at depth near-ties) on the dumbbell against its
    copy scaled by 0.9 and moved."""
    v, f = _dumbbell()
    w = v * 0.9 + [0.03, -0.02, 0.01]
    assert np.array_equal(jm.sample_surface(v, f, 500, 4),
                          tm.sample_surface(v, f, 500, 4))
    cj = jm.mesh_chamfer(v, f, w, f, n=3000)
    ct = tm.mesh_chamfer(v, f, w, f, n=3000, device="cpu")
    assert ct == pytest.approx(cj, rel=1e-5)
    vj = jm.volume_iou(v, f, w, f, dim=24)
    vt = tm.volume_iou(v, f, w, f, dim=24, device="cpu")
    assert 0.5 < vt < 0.95 and abs(vt - vj) <= 2e-3
    sj = jm.silhouette_iou(v, f, w, f, n_views=3, resolution=48)
    st = tm.silhouette_iou(v, f, w, f, n_views=3, resolution=48,
                           device="cpu")
    assert 0.5 < st < 0.98 and abs(st - sj) <= 2e-3
    assert tm.mesh_chamfer(v, f, v, f, n=2000, device="cpu") < 5e-3
    print(f"chamfer {ct} (JAX {cj}), volume IoU {vt} ({vj}), silhouette "
          f"IoU {st} ({sj})")


def test_ray_cull_keeps_rays_that_start_inside():
    """Rays that start inside the box, or graze it, are tested; a ray with
    a zero direction misses."""
    v, f = icosphere(2)
    o = np.asarray([[0, 0, 0], [2, 0, 0], [2, 0, 0], [0, 0, 0]], np.float32)
    d = np.asarray([[0, 0, 1], [-1, 0, 0], [0, 1, 0], [0, 0, 0]], np.float32)
    t = tq.ray_mesh_first_hit(torch.tensor(o), torch.tensor(d),
                              torch.tensor(v, dtype=torch.float32),
                              torch.tensor(f)).numpy()
    jt = _jax_hit_full(o, d, v, f)[0]
    np.testing.assert_allclose(t, jt, rtol=1e-6)
    assert np.isfinite(t[:2]).all() and np.isinf(t[2:]).all()


def test_sdf_grid_matches_jax_up_to_sign_ties():
    """mesh/remesh.py's distance grid of the dented scene (24³, the grid
    tet_remesh_from_surface signs) against JAX's: |sd| to 1e-5 everywhere,
    sd to 1e-5 but at sign ties (f64, as above), which stay under 0.1% of
    the grid (6 of 13,824 here: the nearest faces at the dent's rim)."""
    from tssplat_tpu.mesh.remesh import _sdf_grid as jax_grid
    from tssplat_torch.mesh.remesh import _sdf_grid

    v, f = _dented()
    js, jlo, jsp = jax_grid(v, f, 24)
    ts, tlo, tsp = _sdf_grid(v, f, 24, device="cpu")
    assert np.array_equal(jlo, tlo) and np.array_equal(jsp, tsp)
    js, ts = js.ravel(), ts.ravel()
    np.testing.assert_allclose(np.abs(ts), np.abs(js), atol=1e-5, rtol=0)
    flip = np.sign(ts) != np.sign(js)
    hi = v.max(axis=0) + 0.05
    axes = [np.linspace(jlo[d], hi[d], 24) for d in range(3)]
    g = np.stack(np.meshgrid(*axes, indexing="ij"), -1).reshape(-1, 3)
    assert np.all(_sign_ties(g[flip].astype(np.float32), v, f))
    assert flip.sum() <= 1e-3 * js.size
    np.testing.assert_allclose(ts[~flip], js[~flip], atol=1e-5, rtol=0)
    print(f"dented 24³ grid: {int(flip.sum())} sign ties of {js.size}")
