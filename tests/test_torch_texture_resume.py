"""The port's texture stage through its driver: full-state checkpoints of
the material's dict of tensors and resume. The dataset (4 views of 48² of
the ellipsoid, written by the port's own writer) and the frozen geometry
(one TetSphere exported by the port, read by the multi-sphere geometry's
init path C) need no JAX."""

import json

import numpy as np
import torch

import tssplat_torch.train as torch_train
from tssplat_torch.config import ConfigDict
from tssplat_torch.geometry import TetMeshGeometry
from tssplat_torch.mesh.spheres import icosphere, tet_sphere
from tssplat_torch.mesh.tetmesh import TetMesh
from tssplat_torch.tools.synthetic import write_synthetic_dataset
from tssplat_torch.utils.checkpoint import latest_checkpoint_step
from tssplat_torch.utils.tree import tree_leaves

torch.set_num_threads(1)


def test_texture_resume_matches_straight_run(tmp_path, capsys):
    """The exact path: 4 iterations with checkpoint_every 2, then
    resume=true to 6, give the state of 6 straight iterations: every leaf
    of the material, of its best copy and of both optimizer moments within
    atol 1e-6, the counter at 5 leaves x 6 steps, the same best iteration.
    The learning rate equals eta_min, so the cosine schedule is flat and
    does not depend on total_num_iter."""
    v, f = icosphere(subdivisions=3)
    write_synthetic_dataset(str(tmp_path / "img"),
                            v * np.asarray([0.30, 0.24, 0.18]), f,
                            n_views=4, resolution=48, device="cpu")
    geo = TetMeshGeometry(dict(use_smooth_barrier=False),
                          tetmesh=TetMesh(*tet_sphere(0.1, radius=0.3)),
                          device="cpu")
    geo.export(str(tmp_path / "geo"), "final")
    mesh = geo.tetmesh
    (tmp_path / "geo" / "spheres_vtx_idx.json").write_text(
        json.dumps([list(range(mesh.num_vertices))]))
    (tmp_path / "geo" / "spheres_elem_idx.json").write_text(
        json.dumps([mesh.elem.tolist()]))
    enc = {"otype": "HashGrid", "n_levels": 6, "n_features_per_level": 2,
           "log2_hashmap_size": 11, "base_resolution": 4,
           "per_level_scale": 1.5}

    def run(out, iters, **over):
        cfg = {
            "fitting_stage": "texture",
            "geometry_type": "TetMeshMultiSphereGeometry",
            "geometry": {"use_smooth_barrier": False,
                         "initial_mesh_path": str(tmp_path / "geo")},
            "material_type": "ExplicitMaterial",
            "material": {"pos_encoding_config": enc},
            "dataloader_type": "MistubaImgDataLoader",
            "data": {"dataset_config": {"image_root": str(tmp_path / "img")},
                     "batch_size": 4, "total_num_iter": iters},
            "optimizer": {"lr": 1e-4},
            "output_path": str(tmp_path / out), "total_num_iter": iters,
            "log_every": 100, **over}
        return torch_train.train(ConfigDict(cfg), device="cpu")[0]

    run("resume", 4, checkpoint_every=2)
    assert latest_checkpoint_step(str(tmp_path / "resume" / "ckpt")) == 2
    got = run("resume", 6, checkpoint_every=2, resume=True)
    out = capsys.readouterr().out
    assert "resumed from checkpoint at iter 2" in out
    assert "exact texture fast path" in out
    want = run("straight", 6)
    for g, w in ((got.params, want.params),
                 (got.best_params, want.best_params),
                 (got.opt_state.g1, want.opt_state.g1),
                 (got.opt_state.g2, want.opt_state.g2)):
        gl, wl = tree_leaves(g), tree_leaves(w)
        assert len(gl) == len(wl) == 5
        for a, b in zip(gl, wl):
            np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-6)
    assert int(got.opt_state.cc) == int(want.opt_state.cc) == 30
    assert int(got.best_iter) == int(want.best_iter)
    # the geometry stayed frozen
    np.testing.assert_allclose(np.load(tmp_path / "straight" / "final" /
                                       "final_vtx.npy"), mesh.vtx, atol=1e-6)
