"""Jobs that the port's multi-rank tests run on each rank through
``tssplat_torch.tools.run_ranks`` (``run_ranks("torch_rank_jobs:<job>",
...)`` with this directory on PYTHONPATH). They import the port only:
the tests hold their results against the JAX package in the test process.
Arrays come in and go out as ``.npz`` / ``.pt`` files named by the test.
"""

import time

import numpy as np
import torch
import torch.distributed as dist

from tssplat_torch.utils.env import get_rank, get_world_size


def fail_on(rank: int) -> dict:
    """Raise on ``rank``; the other ranks wait in a collective for it."""
    if get_rank() == rank:
        raise RuntimeError(f"rank {rank} fails on purpose")
    dist.all_reduce(torch.ones(1))
    return {}


def sleep_on(rank: int, seconds: float) -> dict:
    """Sleep ``seconds`` on ``rank`` and write this rank's pid first."""
    import os
    with open(os.path.join(os.environ["TSS_TEST_DIR"],
                           f"pid{get_rank()}"), "w") as f:
        f.write(str(os.getpid()))
    if get_rank() == rank:
        time.sleep(seconds)
    return {}


def sums(value: float) -> dict:
    """The all_reduce of (rank + value) and rank 0's broadcast value."""
    t = torch.tensor([get_rank() + value])
    dist.all_reduce(t)
    b = torch.tensor([float(get_rank())])
    dist.broadcast(b, src=0)
    return {"sum": float(t), "bcast": float(b), "rank": get_rank(),
            "world": get_world_size()}


def _sphere_geometry(h: float, radius: float, energy: bool):
    from tssplat_torch.geometry import TetMeshGeometry
    from tssplat_torch.mesh.spheres import tet_sphere
    from tssplat_torch.mesh.tetmesh import TetMesh
    cfg = dict(use_smooth_barrier=energy)
    if energy:
        cfg["smooth_barrier_param"] = {"smooth_eng_coeff": 1e-3,
                                       "barrier_coeff": 1e-3,
                                       "increase_order_iter": 100}
    v, t = tet_sphere(h, radius=radius)
    return TetMeshGeometry(cfg, tetmesh=TetMesh(v, t), device="cpu")


def spatial_loss(batch_npz: str, out: str, n_sp: int, res: int,
                 fit_depth: bool, fit_normal: bool, it: int = 0) -> dict:
    """This rank's share of ``spatial_geometry_loss`` on tet_sphere(0.12,
    radius=0.3) with the energy, summed over the ranks with the step's
    collective (``sync_step``, SUM): the loss and its gradient, saved to
    ``out`` by rank 0."""
    from tssplat_torch.parallel.mesh import SUM, sync_step
    from tssplat_torch.parallel.spatial import (shard_spatial_train_batch,
                                                spatial_geometry_loss)
    geo = _sphere_geometry(0.12, 0.3, energy=True)
    batch = {k: torch.from_numpy(v) for k, v in np.load(batch_npz).items()}
    rank, world = get_rank(), get_world_size()
    n_view = world // n_sp
    local = shard_spatial_train_batch(batch, rank, n_view, n_sp)
    x = geo.tet_v.detach().clone().requires_grad_(True)
    loss, (il, rg, nd) = spatial_geometry_loss(
        x, geo.statics, local, it, rank, n_view, n_sp, res,
        fit_depth=fit_depth, fit_normal=fit_normal)
    g, = torch.autograd.grad(loss, [x])
    (g,), il, rg, nd = sync_step([g], il.detach(), rg.detach(), nd, SUM)
    if rank == 0:
        torch.save(g, out)
    return {"loss": float(il * 100.0 + rg), "img_loss": float(il),
            "reg": float(rg), "n_drop": int(nd)}


def exact_loss(data_npz: str, params_npz: str, enc: dict, res: int,
               out: str, it: int = 0) -> dict:
    """The view-sharded exact texture loss on tet_sphere(0.08, radius=0.3)
    with the material's parameters from ``params_npz`` (leaf names as
    ``material.npz``): each rank caches its group of the views, the loss
    and the gradients summed over the ranks (``sync_step``, SUM); rank 0
    saves the gradients to ``out``."""
    from tssplat_torch.materials import ExplicitMaterial
    from tssplat_torch.materials.exact_stage import (
        build_texture_exact_cache, build_texture_exact_loss)
    from tssplat_torch.parallel.mesh import SUM, sync_step
    from tssplat_torch.utils.tree import tree_leaves, tree_unflatten
    geo = _sphere_geometry(0.08, 0.3, energy=False)
    data = {k: torch.from_numpy(v) for k, v in np.load(data_npz).items()}
    mat = ExplicitMaterial({"pos_encoding_config": dict(enc)}, device="cpu")
    flat = np.load(params_npz)
    mat.params = {g: {n: torch.from_numpy(flat[f"{g}/{n}"])
                      for n in mat.params[g]} for g in mat.params}
    rank, world = get_rank(), get_world_size()
    cache = build_texture_exact_cache(geo, mat, data, res,
                                      shard=(rank, world))
    loss_fn = build_texture_exact_loss(mat, geo.statics, cache)
    p = {g: {n: x.requires_grad_(True) for n, x in d.items()}
         for g, d in mat.params.items()}
    il, rg = loss_fn(p, it)
    grads = torch.autograd.grad(il * 100.0, tree_leaves(p))
    leaves, il, rg, _ = sync_step(list(grads), il.detach(), rg,
                                  torch.zeros((), dtype=torch.int64), SUM)
    if rank == 0:
        torch.save(tree_unflatten(p, leaves), out)
    return {"img_loss": float(il), "views": cache["n"]}


def auto_view_chunk(free: list, B: int, res: int, tile_k: int) -> dict:
    """The ``view_chunk: auto`` rule over this world's ranks, as view data
    parallelism calls it, with rank r's free device bytes ``free[r]``."""
    from tssplat_torch.train import _auto_view_chunk
    return {"chunk": _auto_view_chunk(B, get_world_size(), res,
                                      tile_k=tile_k,
                                      free_bytes=free[get_rank()])}
