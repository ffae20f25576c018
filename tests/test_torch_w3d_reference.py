"""The benchmark's Wonder3D-layout configuration (img_to_3d_wonder3d) at a
small size on the CPU: the inputs writer's targets against the port's
Wonder3DImgDataset, and the port's orthographic geometry step (the
benchmark's own path: ``benchmark/program.py`` -> the driver's registries
and ``make_train_step``) against the plain reference
``benchmark/reference/ortho_steps.py`` for three steps. Two deliberately
wrong references and the TF32 control must fail the same comparison.

2 spheres, 6 views, 32² PNGs loaded at 64², the sphere layout and the
target drawn from the seed."""

import dataclasses
import os
import sys

import numpy as np
import pytest
import torch
import yaml

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from benchmark import run  # noqa: E402
from benchmark.manifest import Cell  # noqa: E402
from benchmark.reference import ortho_steps  # noqa: E402
from benchmark.reference.compare import readings  # noqa: E402
from benchmark.reference.raster import vertex_normals  # noqa: E402
from benchmark.tests.tiny import make_root  # noqa: E402

from tssplat_torch import train as tt  # noqa: E402
from tssplat_torch.data import Wonder3DImgDataset  # noqa: E402

torch.set_num_threads(1)

CELL = "w3d_geo_6v"
SEED = 2147483711
DEV = torch.device("cpu")
# Tolerances of (b), each a gap of compare.py (relative to the reference).
# On the CPU the program runs the kernels' plain versions, which compute
# each pixel as the reference does; the two part only by the order of
# float32 sums (the mean over 6 x 64² pixels, the vertex normals' and the
# gradient's scatter-adds): a few ulps of the loss, and a relative 1e-6 of
# the gradient's norm. AdamUniform divides by the largest component, so a
# rounding difference there reaches every component of the step: the
# change's tolerance is ten times the gradient's.
TOL = {"loss_gap": 2e-6, "grad_gap": 1e-5, "change_gap": 1e-4}


def _root(tmp_path, distance=None):
    """A throwaway checkout root at the small size; ``distance`` moves the
    cameras."""
    root = make_root(tmp_path, spheres=2, views=6, res=64)
    b = root / "benchmark"
    t = b / "traffic" / "w3d_nrm_6v_512.yaml"
    traffic = yaml.safe_load(t.read_text())
    traffic["png"] = 32
    t.write_text(yaml.safe_dump(traffic))
    if distance is not None:
        f = b / "configs" / "img_to_3d_wonder3d.yaml"
        c = yaml.safe_load(f.read_text())
        c["assumed"]["camera_distance"] = distance
        f.write_text(yaml.safe_dump(c, sort_keys=False))
    return root


def _program(root, tmp_path):
    """The problem, and the program's losses, first gradient and change
    after each of its first three steps; the keyword arguments the step
    was built with."""
    built = []
    make = tt.make_train_step

    def spy(*args, **kw):
        built.append(kw)
        return make(*args, **kw)

    cell = Cell(CELL, root)
    prob, overrides = run.make_inputs(cell, SEED, str(tmp_path / "in"), DEV)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tt, "make_train_step", spy)
        prog_run, _ = run.build_program(cell, prob, overrides, SEED, DEV)
        start = prog_run.state.params.detach().clone()
        losses, grad, change = [], None, []
        for it in range(3):
            out = prog_run.iterate(it)
            losses.append(float(out[0]))
            if it == 0:
                grad = float(torch.linalg.norm(prog_run.state.opt_state.g1
                                               / (1.0 - prog_run.b1)))
            change.append(float(torch.linalg.norm(prog_run.state.params
                                                  - start)))
    return prob, {"losses": losses, "grad": grad, "change": change}, built


def _gaps(prog: dict, reference_cls, prob, n: int = 3, **kw) -> dict:
    """compare.py's gaps between the program after ``n`` steps and a
    reference following ``n`` steps."""
    ref = reference_cls(prob, DEV, **kw).follow(n)
    return readings({"names": ["tet_v"], "losses": prog["losses"][:n],
                     "grad_norms": [prog["grad"]],
                     "change_norms": [prog["change"][n - 1]]}, ref)


def _within(gaps: dict) -> bool:
    return all(gaps[k] <= v for k, v in TOL.items())


@pytest.fixture(scope="module")
def small(tmp_path_factory):
    """{camera distance: (problem, program readings, step kwargs)}: the
    configuration's cameras (2.5), and cameras at 3.3, where the back of the
    spheres passes clip z 1 before the division by 6."""
    out = {}
    for d in (2.5, 3.3):
        tmp = tmp_path_factory.mktemp(f"w3d_{d}")
        out[d] = _program(_root(tmp, None if d == 2.5 else d), tmp)
    return out


def test_writer_targets_are_the_datasets(tmp_path):
    """(a) The problem's targets equal the port's Wonder3DImgDataset's
    arrays on the written layout (both decode the PNGs and resize them with
    OpenCV's bicubic filter: within 1 ulp), for every written view, in the
    dataset's view order; the alpha is 0 or 1, the cameras are the
    written mvp, and the image is not empty."""
    root = _root(tmp_path)
    cell = Cell(CELL, root)
    prob, ov = run.make_inputs(cell, SEED, str(tmp_path / "in"), DEV)
    ds = Wonder3DImgDataset({
        "image_root": ov["data.dataset_config.image_root"],
        "camera_mvp_root": ov["data.dataset_config.camera_mvp_root"],
        "camera_views": ov["data.dataset_config.camera_views"],
        "resolution": ov["data.dataset_config.resolution"]})
    assert len(ds) == 6 and ds.resolution == 64
    assert prob.rgba.shape == prob.normal.shape == (6, 64, 64, 4)
    for ours, theirs in ((prob.rgba, ds.all_tgt_imgs),
                         (prob.normal, ds.all_tgt_ns),
                         (prob.mvp, ds.all_mvp_mats)):
        np.testing.assert_array_max_ulp(ours, np.stack(theirs), maxulp=1)
    assert set(np.unique(prob.rgba[..., 3])) == {0.0, 1.0}
    assert 0.02 < prob.rgba[..., 3].mean() < 0.6
    np.testing.assert_array_equal(prob.mv, prob.mvp)


@pytest.mark.parametrize("distance", [2.5, 3.3])
def test_program_matches_the_orthographic_reference(small, distance):
    """(b) Loss of iterations 0-2, the first gradient and the change after
    each step, within TOL of the reference, through a step built
    orthographic with the normal term at weight 10."""
    prob, prog, built = small[distance]
    assert built and all(kw["is_ortho"] and kw["fit_normal"]
                         and kw["normal_weight"] == 10.0
                         and not kw["fit_depth"] for kw in built)
    for n in (1, 2, 3):
        gaps = _gaps(prog, ortho_steps.Reference, prob, n)
        assert _within(gaps), (n, gaps)


class _NoZDiv(ortho_steps.Reference):
    """Wrong: the perspective path's clip, without the division by 6."""

    def clip(self, points, mvp):
        return ortho_steps.clip_positions(points, mvp, self.prec)


class _NoFlip(ortho_steps.Reference):
    """Wrong: the vertex normals as they are, z not negated."""

    def normals(self, x):
        return vertex_normals(x[self.surface_vid], self.faces)


@pytest.mark.parametrize("wrong", [_NoZDiv, _NoFlip],
                         ids=["no_z_division", "no_flip"])
def test_a_wrong_reference_fails_the_comparison(small, wrong):
    """(c) Each departure the reference holds the program to shows: without
    the flip the normal term compares mirrored normals; without z / 6 the
    clip test at z <= 1 cuts the back of the spheres. Under the
    configuration's cameras every surface point's clip z lies in
    [0.6, 0.9] before the division, where dividing moves no winner, so the
    division is checked with the cameras at 3.3."""
    prob, prog, _ = small[3.3]
    assert not _within(_gaps(prog, wrong, prob))


def test_the_tf32_control_fails_the_comparison(small):
    """(d) The reference with its clip transform's operands rounded to
    TF32 exceeds a tolerance of (b)."""
    prob, prog, _ = small[2.5]
    assert not _within(_gaps(prog, ortho_steps.Reference, prob,
                             precision="tf32"))


def test_the_reference_refuses_a_depth_term(small):
    """The layout's depth target is the alpha and campos a placeholder:
    the reference raises rather than compare a depth."""
    prob, _, _ = small[2.5]
    with pytest.raises(ValueError, match="depth"):
        ortho_steps.Reference(dataclasses.replace(
            prob, cfg={**prob.cfg, "fit_depth": True}), DEV)


def test_pair_counts_under_the_orthographic_projection(small):
    """The rooflines' pair counts at the start: differing pairs along the
    silhouettes of all six views, valid ones among them, and the owners
    within the pixels."""
    prob, _, _ = small[2.5]
    x = torch.as_tensor(prob.verts, dtype=torch.float32)
    counts = ortho_steps.pair_counts_of(prob, x, True, DEV)
    assert 0 < counts["pairs_valid"] <= counts["pairs_differ"]
    assert 0 < counts["px_owner"] <= 6 * 64 * 64
