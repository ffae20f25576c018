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
from tssplat_torch.ops.transform import fibonacci_views
from tssplat_torch.optim import adam_uniform, cosine_annealing_lr
from tssplat_torch.tools.synthetic import render_views_of_mesh
from tssplat_torch.train import init_train_state, make_train_step
from tssplat_torch.utils import profiling

torch.set_num_threads(1)

RES = 64
VIEWS = 4
CHUNK = 2
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


def _step(scene, case):
    """(step, state, batch) of one case: the chunked silhouette step, the
    chunked depth + normal step, or the exact texture step."""
    (v, t), batch = scene
    init_fn, update_fn = adam_uniform(
        cosine_annealing_lr(0.2, 100), grad_limit=True,
        grad_limit_values=(0.01, 0.01), grad_limit_iters=(50,))
    if case == "texture":
        geo = TetMeshGeometry(dict(use_smooth_barrier=False),
                              tetmesh=TetMesh(v, t), device="cpu")
        mat = ExplicitMaterial({"pos_encoding_config": dict(ENC)},
                               device="cpu")
        cache = build_texture_exact_cache(geo, mat, batch, RES)
        step = make_train_step(
            geo.statics, update_fn, resolution=RES,
            material_fn=mat.apply_fn, tet_v_frozen=geo.tet_v,
            texture_exact_loss=build_texture_exact_loss(mat, geo.statics,
                                                        cache))
        return step, init_train_state(mat.params, init_fn), {}
    geo = TetMeshGeometry(dict(use_smooth_barrier=True),
                          tetmesh=TetMesh(v, t), device="cpu")
    dn = case == "depth_normal"
    step = make_train_step(geo.statics, update_fn, resolution=RES,
                           fit_depth=dn, fit_normal=dn, view_chunk=CHUNK)
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
# the spans each step opens, and (child, parent): every child inside one
GEOMETRY = {"tssplat.step": 1, "tssplat.visibility": CHUNKS,
            "tssplat.binning": CHUNKS, "tssplat.sync.binning": CHUNKS,
            "tssplat.sync.bincount": CHUNKS,
            # the forward, and the checkpoint's recompute in the backward
            "tssplat.render": 2 * CHUNKS, "tssplat.energy": 1,
            "tssplat.backward": 1, "tssplat.optim": 1,
            # AdamUniform's constants (3 sites) and the best iteration
            "tssplat.sync.optim": 4}
NESTED = [("tssplat.visibility", "tssplat.step"),
          ("tssplat.binning", "tssplat.visibility"),
          ("tssplat.sync.binning", "tssplat.binning"),
          ("tssplat.sync.bincount", "tssplat.binning"),
          ("tssplat.render", "tssplat.step"),
          ("tssplat.energy", "tssplat.step"),
          ("tssplat.backward", "tssplat.step"),
          ("tssplat.optim", "tssplat.step"),
          ("tssplat.sync.optim", "tssplat.optim")]
CASES = {
    "silhouette": (GEOMETRY, NESTED),
    "depth_normal": (GEOMETRY, NESTED + [
        ("tssplat.sync.row_gather", "tssplat.step"),
        ("tssplat.sync.normals", "tssplat.render")]),
    "texture": ({"tssplat.step": 1, "tssplat.encoding": 1,
                 "tssplat.mlp": 1, "tssplat.antialias_color": 1,
                 "tssplat.backward": 1, "tssplat.optim": 1,
                 "tssplat.render": 0, "tssplat.visibility": 0},
                [("tssplat.encoding", "tssplat.step"),
                 ("tssplat.mlp", "tssplat.step"),
                 ("tssplat.antialias_color", "tssplat.step"),
                 ("tssplat.sync.row_gather", "tssplat.antialias_color"),
                 ("tssplat.sync.encoding", "tssplat.encoding")]),
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
    if case == "depth_normal":
        # the row gathers wait in the forward and its recompute (inside
        # the render) and in their backward (outside it)
        n = names.count("tssplat.sync.row_gather")
        in_render = _inside(spans, "tssplat.sync.row_gather",
                            "tssplat.render")
        in_backward = _inside(spans, "tssplat.sync.row_gather",
                              "tssplat.backward")
        assert 0 < in_render < n and n - in_render < in_backward


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
