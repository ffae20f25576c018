"""The port's spans (tssplat_torch/utils/profiling.py span) on the CPU
profiler: which ``tssplat.*`` ranges a train step opens, how they nest,
and that without a profiler a step enters no ``record_function`` and
computes the same bits."""

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile
from torch.utils._pytree import tree_leaves

from tssplat_torch.geometry import TetMeshGeometry
from tssplat_torch.materials import ExplicitMaterial
from tssplat_torch.materials.exact_stage import (build_texture_exact_cache,
                                                 build_texture_exact_loss)
from tssplat_torch.mesh.spheres import icosphere, tet_sphere
from tssplat_torch.mesh.tetmesh import TetMesh
from tssplat_torch.ops.transform import fibonacci_views, look_at
from tssplat_torch.optim import adam_uniform, cosine_annealing_lr
from tssplat_torch.tools.synthetic import render_views_of_mesh
from tssplat_torch.train import (build_texture_sample_cache,
                                 init_train_state, make_train_step)
from tssplat_torch.utils import profiling

torch.set_num_threads(1)

RES = 64
VIEWS = 4
CHUNK = 2
SAMPLE = 64                   # the sampled texture path's pixels a view
ENC = {"otype": "HashGrid", "n_levels": 4, "n_features_per_level": 2,
       "log2_hashmap_size": 10, "base_resolution": 4,
       "per_level_scale": 1.6}


@pytest.fixture(scope="module")
def scene():
    """A small tet sphere, and the ellipsoid's RGBA, depth and normal
    targets in VIEWS views of RES² (the RGB over a white background)."""
    v, t = tet_sphere(0.12, radius=0.3)
    sv, sf = icosphere(subdivisions=2)
    sv = sv * np.asarray([0.3, 0.24, 0.18])
    mvp, _, campos = fibonacci_views(VIEWS)
    rgba, depth, normal = render_views_of_mesh(sv, sf, mvp, campos, RES,
                                               device="cpu")
    bg = np.ones((VIEWS, RES, RES, 3), np.float32)
    rgb = bg + (rgba[..., :3] - bg) * rgba[..., 3:4]
    batch = {"mvp": mvp, "campos": campos, "background": bg,
             "img": np.concatenate([rgb, rgba[..., 3:4]], -1),
             "d": depth[..., None], "n": normal}
    return (v, t), {k: torch.as_tensor(np.asarray(a), dtype=torch.float32)
                    for k, a in batch.items()}


def _ortho_mvps():
    """Wonder3D's orthographic cameras (tests/test_wonder3d.py's
    ``diag(1.2, -1.2, -0.3, 1) @ look_at(2.5)``) at VIEWS azimuths."""
    mvps = []
    for a in np.radians(np.arange(VIEWS) * 360.0 / VIEWS):
        mv = look_at(np.asarray([np.sin(a), 0.0, np.cos(a)]) * 2.5,
                     [0, 0, 0], [0, 1, 0])
        mvps.append(np.diag([1.2, -1.2, -0.3, 1.0]) @ mv)
    return torch.as_tensor(np.stack(mvps), dtype=torch.float32)


def _step(scene, case):
    """(step, state, batch) of one case: the silhouette or the depth +
    normal step in chunks of CHUNK views or in one batch; the orthographic
    normal-only step of the Wonder3D cell (one batch; Wonder3D's cameras
    over the perspective views' targets: the spans do not depend on the
    pixels); the exact or the cached sampled texture step."""
    (v, t), batch = scene
    init_fn, update_fn = adam_uniform(
        cosine_annealing_lr(0.2, 100), grad_limit=True,
        grad_limit_values=(0.01, 0.01), grad_limit_iters=(50,))
    if case.startswith("texture"):
        geo = TetMeshGeometry(dict(use_smooth_barrier=False),
                              tetmesh=TetMesh(v, t), device="cpu")
        mat = ExplicitMaterial({"pos_encoding_config": dict(ENC)},
                               device="cpu")
        if case == "texture":
            cache = build_texture_exact_cache(geo, mat, batch, RES)
            kw = dict(texture_exact_loss=build_texture_exact_loss(
                mat, geo.statics, cache))
            batch = {}
        else:
            kw = dict(texture_sample_px=SAMPLE,
                      texture_cache=build_texture_sample_cache(
                          geo.statics, geo.tet_v, batch["mvp"],
                          batch["img"], RES))
            batch = dict(batch, view_idx=torch.arange(VIEWS,
                                                      dtype=torch.int32))
        step = make_train_step(geo.statics, update_fn, resolution=RES,
                               material_fn=mat.apply_fn,
                               tet_v_frozen=geo.tet_v, **kw)
        return step, init_train_state(mat.params, init_fn), batch
    geo = TetMeshGeometry(dict(use_smooth_barrier=True),
                          tetmesh=TetMesh(v, t), device="cpu")
    ortho = case == "ortho_normal_one_batch"
    if ortho:
        batch = dict(batch, mvp=_ortho_mvps())
    step = make_train_step(
        geo.statics, update_fn, resolution=RES, is_ortho=ortho,
        fit_depth=case.startswith("depth_normal"),
        fit_normal=not case.startswith("silhouette"),
        view_chunk=0 if case.endswith("one_batch") else CHUNK)
    return step, init_train_state(geo.tet_v, init_fn), batch


def _profiled(fn):
    """fn()'s result and its tssplat.* spans [(name, start, end)]."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    return out, [(e.name, e.time_range.start, e.time_range.end)
                 for e in prof.events() if e.name.startswith("tssplat.")]


def _inside(spans, child, parent):
    """How many ``child`` spans lie within some ``parent`` span."""
    outer = [(a, b) for n, a, b in spans if n == parent]
    return sum(1 for n, a, b in spans if n == child
               and any(p <= a and b <= q for p, q in outer))


CHUNKS = VIEWS // CHUNK
# the spans each step opens, and (child, parent): every child inside one;
# the binning's pair total is a step's only wait (no bincount read, no
# copy of the optimizer's constants, the best iteration or the normals')
GEOMETRY = {"tssplat.step": 1, "tssplat.visibility": CHUNKS,
            "tssplat.binning": CHUNKS, "tssplat.sync.binning": CHUNKS,
            "tssplat.sync.bincount": 0,
            # the forward, and the checkpoint's recompute in the backward
            "tssplat.render": 2 * CHUNKS, "tssplat.energy": 1,
            "tssplat.backward": 1, "tssplat.optim": 1,
            "tssplat.sync.optim": 0}
# one batch: one binning, in front of the rest of the step (its own
# visibility span), the visibility kernel's span in the render, and one
# render, no recompute
ONE_BATCH = {**GEOMETRY, "tssplat.visibility": 2, "tssplat.binning": 1,
             "tssplat.sync.binning": 1, "tssplat.render": 1}
NESTED = [("tssplat.visibility", "tssplat.step"),
          ("tssplat.binning", "tssplat.visibility"),
          ("tssplat.sync.binning", "tssplat.binning"),
          ("tssplat.render", "tssplat.step"),
          ("tssplat.energy", "tssplat.step"),
          ("tssplat.backward", "tssplat.step"),
          ("tssplat.optim", "tssplat.step")]
# the normal shading in each render
SHADED = NESTED + [("tssplat.sync.row_gather", "tssplat.step"),
                   ("tssplat.normals", "tssplat.render")]
# one batch: the normal shading once; the CPU's row gathers wait 11 times
# with the depth term, 8 without it
NORMALS = {"tssplat.normals": 1, "tssplat.sync.normals": 0}
CASES = {
    "silhouette": ({**GEOMETRY, "tssplat.normals": 0}, NESTED),
    "silhouette_one_batch": ({**ONE_BATCH, "tssplat.normals": 0}, NESTED),
    "depth_normal": ({**GEOMETRY, "tssplat.normals": 2 * CHUNKS}, SHADED),
    "depth_normal_one_batch": ({**ONE_BATCH, **NORMALS,
                                "tssplat.sync.row_gather": 11}, SHADED),
    "ortho_normal_one_batch": ({**ONE_BATCH, **NORMALS,
                                "tssplat.sync.row_gather": 8}, SHADED),
    # the exact path: the antialias's rows and weights are the cache's, so
    # its tail (K10 or its plain chain) waits on no row gather
    "texture": ({"tssplat.step": 1, "tssplat.encoding": 1,
                 "tssplat.mlp": 1, "tssplat.antialias_color": 1,
                 "tssplat.backward": 1, "tssplat.optim": 1,
                 "tssplat.render": 0, "tssplat.visibility": 0,
                 "tssplat.sync.row_gather": 0},
                [("tssplat.encoding", "tssplat.step"),
                 ("tssplat.mlp", "tssplat.step"),
                 ("tssplat.antialias_color", "tssplat.step"),
                 ("tssplat.sync.encoding", "tssplat.encoding"),
                 ("tssplat.backward", "tssplat.step"),
                 ("tssplat.optim", "tssplat.step")]),
    # the cached sampled path: no visibility and no colour antialias
    "texture_sampled": ({"tssplat.step": 1, "tssplat.encoding": 1,
                         "tssplat.mlp": 1, "tssplat.antialias_color": 0,
                         "tssplat.backward": 1, "tssplat.optim": 1,
                         "tssplat.sync.optim": 0, "tssplat.render": 0,
                         "tssplat.visibility": 0,
                         "tssplat.sync.row_gather": 0},
                        [("tssplat.encoding", "tssplat.step"),
                         ("tssplat.mlp", "tssplat.step"),
                         ("tssplat.sync.encoding", "tssplat.encoding"),
                         ("tssplat.backward", "tssplat.step"),
                         ("tssplat.optim", "tssplat.step")]),
}


@pytest.mark.parametrize("case", list(CASES))
def test_step_opens_its_spans_nested(scene, case):
    step, state, batch = _step(scene, case)
    _, spans = _profiled(lambda: step(state, batch, 1))
    counts, nested = CASES[case]
    names = [n for n, _, _ in spans]
    assert {n: names.count(n) for n in counts} == counts
    for child, parent in nested:
        assert 0 < _inside(spans, child, parent) == names.count(child), \
            (child, parent)
    # every recompute runs inside the backward
    assert _inside(spans, "tssplat.render", "tssplat.backward") == \
        counts["tssplat.render"] // 2
    if counts.get("tssplat.normals"):
        # the row gathers wait in the forward and any recompute (inside
        # the render) and in their backward (outside it); without a
        # recompute each wait is in the forward's render or the backward
        n = names.count("tssplat.sync.row_gather")
        in_render = _inside(spans, "tssplat.sync.row_gather",
                            "tssplat.render")
        in_backward = _inside(spans, "tssplat.sync.row_gather",
                              "tssplat.backward")
        assert 0 < in_render < n
        if counts["tssplat.render"] > 1:
            assert n - in_render < in_backward
        else:
            assert n - in_render == in_backward


@pytest.mark.parametrize("case", list(CASES))
def test_no_profiler_enters_no_record_function(scene, case, monkeypatch):
    """Without a profiler no span enters record_function, and the step's
    outputs and new state are bit-equal to a profiled step's."""
    calls = []
    real = profiling.record_function

    def counting(name):
        calls.append(name)
        return real(name)

    monkeypatch.setattr(profiling, "record_function", counting)
    step, state, batch = _step(scene, case)
    plain = step(state, batch, 1)
    assert calls == []
    traced, _ = _profiled(lambda: step(state, batch, 1))
    assert "tssplat.step" in calls
    leaves = tree_leaves(plain)
    assert len(leaves) == len(tree_leaves(traced)) > 8
    for a, b in zip(leaves, tree_leaves(traced)):
        assert torch.equal(a, b)
