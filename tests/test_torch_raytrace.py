"""The port's ray tracer (``tssplat_torch.tools.raytrace``) against the JAX
package's, on the CPU. The Lambertian integrator is deterministic and held
to 1e-5; the path integrator draws from a torch.Generator where JAX draws
from jax.random, so it is held to the closed form on a convex body and to
JAX's mean radiance within three standard errors on a concave scene.
"""

import os

import numpy as np
import pytest
import torch

from tssplat_tpu.mesh.spheres import icosphere
from tssplat_tpu.ops.transform import fibonacci_views
from tssplat_tpu.tools import raytrace as jr

from tssplat_torch.data import MitsubaImgDataset
from tssplat_torch.tools import raytrace as tr

torch.set_num_threads(1)


def _dumbbell():
    sv, sf = icosphere(3)
    v = np.concatenate([sv * 0.3 + [-0.45, 0, 0], sv * 0.3 + [0.45, 0, 0]])
    return v, np.concatenate([sf, sf + sv.shape[0]])


@pytest.mark.parametrize("kw", [{}, dict(shadows=True),
                                dict(geo_normal_aov=True, spp=1),
                                dict(vertex_colors="ramp")],
                         ids=["plain", "shadows", "geo_normal", "colors"])
def test_lambert_matches_jax(kw):
    """rgba, depth and normal within 1e-5 of JAX's at 2 views of 32² of
    the dumbbell (spp 4 unless given)."""
    v, f = _dumbbell()
    kw = dict(kw)
    if kw.get("vertex_colors") == "ramp":
        kw["vertex_colors"] = (v - v.min(0)) / np.ptp(v, axis=0)
    mvp, _, campos = fibonacci_views(2)
    want = jr.raytrace_views_of_mesh(v, f, mvp, campos, 32, ray_chunk=4096,
                                     **kw)
    got = tr.raytrace_views_of_mesh(v, f, mvp, campos, 32, ray_chunk=1000,
                                    device="cpu", **kw)
    for a, b in zip(got, want):
        assert a.shape == b.shape and a.dtype == np.float32
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-5)
    assert (got[0][..., 3] > 0).sum() > 100


def test_path_integrator_convex_equals_albedo():
    """On a convex body every bounce escapes: radiance == albedo (median
    within 1e-3, mean within 0.02), as tests/test_raytrace.py holds JAX's."""
    v, f = icosphere(2)
    albedo = np.asarray([0.6, 0.5, 0.4], np.float32)
    mvp, _, campos = fibonacci_views(1)
    rgba, _, _ = tr.raytrace_views_of_mesh(
        v * 0.3, f, mvp, campos, 64, spp=4, integrator="path", max_depth=4,
        base_color=albedo, device="cpu")
    interior = rgba[0, ..., 3] > 0.999
    assert interior.sum() > 100
    col = rgba[0, ..., :3][interior]
    np.testing.assert_allclose(np.median(col, axis=0), albedo, atol=1e-3)
    assert np.abs(col.mean(axis=0) - albedo).max() < 0.02


def _ground_scene():
    """tests/test_raytrace.py's concave scene: a ball of radius 0.3 resting
    on a 2.4-wide ground plane, from the view ~30 degrees above it."""
    sv, sf = icosphere(2)
    g = 1.2
    pv = np.asarray([[-g, -g, -0.3], [g, -g, -0.3],
                     [g, g, -0.3], [-g, g, -0.3]], np.float32)
    pf = np.asarray([[0, 1, 2], [0, 2, 3]], np.int32)
    v = np.concatenate([sv * 0.3, pv]).astype(np.float32)
    f = np.concatenate([sf, pf + len(sv)]).astype(np.int32)
    mvp, _, campos = fibonacci_views(12)
    b = int(np.argmin(np.abs(campos[:, 2] - 2.0)))
    return v, f, mvp[b:b + 1], campos[b:b + 1]


def test_path_integrator_concave_matches_jax_in_the_mean():
    """On the ball-on-ground scene at 48², spp 4, 4 bounces: the mean
    radiance over the foreground pixels within 3 standard errors of JAX's
    (the pixel-paired difference's SE: 0.0017 here, the difference 0.0010),
    the ground darker near the contact than far from it, and depth and
    normal (which draw nothing)
    within 1e-5 of JAX's but at <= 0.2% of the pixels (where a camera ray
    within 1e-5 of a ball's edge goes past it to the ground in one package:
    1 of 2,304 here)."""
    v, f, mvp, campos = _ground_scene()
    kw = dict(spp=4, integrator="path", max_depth=4,
              base_color=(0.8, 0.8, 0.8))
    want = jr.raytrace_views_of_mesh(v, f, mvp, campos, 48, ray_chunk=4096,
                                     **kw)
    got = tr.raytrace_views_of_mesh(
        v, f, mvp, campos, 48, device="cpu",
        generator=torch.Generator().manual_seed(7), **kw)
    for a, b in zip(got[1:], want[1:]):
        err = np.abs(a - b).reshape(48 * 48, -1).max(axis=1)
        assert (err > 1e-5).sum() <= 0.002 * err.size, err.max()
    fg = (got[0][0, ..., 3] > 0.999) & (want[0][0, ..., 3] > 0.999)
    assert fg.sum() > 500
    diff = (got[0][0, ..., :3][fg] - want[0][0, ..., :3][fg]).mean(axis=1)
    se = diff.std(ddof=1) / np.sqrt(diff.size)
    assert abs(diff.mean()) < 3 * se, (diff.mean(), se)
    ground = fg & (np.abs(got[2][0, ..., 2]) > 0.99)
    bright = got[0][0, ..., 0][ground]
    assert np.percentile(bright, 2) < np.percentile(bright, 90) - 0.1
    print(f"mean radiance port {got[0][0, ..., :3][fg].mean():.5f}, JAX "
          f"{want[0][0, ..., :3][fg].mean():.5f}, paired difference "
          f"{diff.mean():.5f} (SE {se:.5f}) over {diff.size} px")


def test_path_integrator_generator_reproducible():
    """The same generator seed gives the same image; another seed another
    image."""
    v, f, mvp, campos = _ground_scene()
    kw = dict(spp=1, integrator="path", max_depth=2, device="cpu")
    a = tr.raytrace_views_of_mesh(v, f, mvp, campos, 16, seed=3, **kw)[0]
    b = tr.raytrace_views_of_mesh(v, f, mvp, campos, 16, seed=3, **kw)[0]
    c = tr.raytrace_views_of_mesh(v, f, mvp, campos, 16, seed=4, **kw)[0]
    assert np.array_equal(a, b) and not np.array_equal(a, c)


def test_raytraced_dataset_matches_jax_and_loads(tmp_path):
    """write_raytraced_dataset (through the CLI) writes JAX's files (PNG
    pixels equal, arrays within 1e-5) and the port's loader reads them."""
    from tssplat_tpu.mesh.io import save_obj
    from PIL import Image

    v, f = icosphere(1)
    save_obj(str(tmp_path / "m.obj"), v * 0.3, f)
    jr.write_raytraced_dataset(str(tmp_path / "jax"), v * 0.3, f, n_views=2,
                               resolution=32, spp=1)
    tr.main(["--mesh", str(tmp_path / "m.obj"), "--save_path",
             str(tmp_path / "torch"), "--num_views", "2", "--resolution",
             "32", "--spp", "1"], device="cpu")
    names = sorted(os.listdir(tmp_path / "jax"))
    assert names == sorted(os.listdir(tmp_path / "torch")) and len(names) == 10
    for n in names:
        a, b = tmp_path / "torch" / n, tmp_path / "jax" / n
        if n.endswith(".png"):
            pa, pb = np.asarray(Image.open(a)), np.asarray(Image.open(b))
            assert np.abs(pa.astype(int) - pb.astype(int)).max() <= 1
        else:
            np.testing.assert_allclose(np.load(a), np.load(b), rtol=0,
                                       atol=1e-5)
    ds = MitsubaImgDataset({"image_root": str(tmp_path / "torch")})
    assert len(ds) == 2 and ds.all_tgt_imgs[0].shape == (32, 32, 4)
