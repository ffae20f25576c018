"""The port's public surface against the JAX package's: every public
function and class of a ``tssplat_tpu`` module (its own, not imported),
every public method of such a class (and its constructor), every argument
of each, and every name a ``tssplat_tpu`` package exports, has a
counterpart of the same name at the same place in ``tssplat_torch``, but
those listed in ``NO_COUNTERPART``, each with its reason (ROADMAP.md lists
them under queue 1's "no counterpart, by design" and queue 3's
"deliberate departures"). One test per top-level module or package of
``tssplat_tpu``; each holds the differences found there to the list, so a
new gap fails and so does an entry that no longer applies."""

import importlib
import inspect
import pkgutil

import pytest

import tssplat_tpu

_KERNELS = "the TPU kernels' entry points; ops/binning.py and the wrappers " \
    "of ops/raster_kernels.py take their place"
_CORNER = "the port's ops take the corner layout only (pos_clip (B,3F,4)): " \
    "no tri / corner"
_VIS = "precomputed visibility is the port's vis=; K1 or K2 is chosen by " \
    "the layout rule, not by a method"
_DROPS = "the port returns (rast, n_drop) where JAX fills drops_out"
_RANKS = "a JAX device mesh or sharding; the port's ranks take its place " \
    "(parallel/mesh.py, parallel/spatial.py)"
_BUCKETS = "avoids TPU scatters; the port's hash-grid backward is " \
    "autograd's scatter-add"
_BINNING = "in ops/binning.py (corner-layout arguments)"

NO_COUNTERPART = {
    "geometry": {
        "ARGS tssplat_tpu.geometry.tet_geometry.permute_surface_vertices: "
        "key": "draws from a torch.Generator, not a jax.random key",
    },
    "materials": {
        "ARGS tssplat_tpu.materials.exact_stage.build_texture_exact_cache: "
        "n_shards": "the port's shard=(rank, n) selects a rank's views",
        "ARGS tssplat_tpu.materials.exact_stage.build_texture_exact_loss: "
        "mesh": _RANKS,
    },
    "models": {
        f"NAME tssplat_tpu.models.networks.{n}": _BUCKETS
        for n in ("build_hash_grad_buckets", "bucketed_hash_encoding_traced",
                  "buckets_as_arrays", "bucketed_hash_encoding")
    },
    "native": {
        "NAME tssplat_tpu.native.available":
            "the JAX package falls back to numpy without its library; the "
            "port builds it or raises",
    },
    "ops": {
        "EXPORT tssplat_tpu.ops.rasterize_ids_tiled": _KERNELS,
        "ARGS tssplat_tpu.ops.energy.EnergyOps: inc_idx":
            "the gather form of JAX's energy backward, which avoids TPU "
            "scatters; the port folds with fold_src / fold_sv / fold_last",
        "ARGS tssplat_tpu.ops.energy.build_energy_ops: dtype":
            "the port takes device= there; its tables are float32, JAX's "
            "default",
        "MODULE tssplat_torch.ops.pallas_raster": _KERNELS,
        "NAME tssplat_tpu.ops.rasterize.rasterize_ids_tiled": _KERNELS,
        "NAME tssplat_tpu.ops.rasterize.default_tile_capacity": _BINNING,
        "NAME tssplat_tpu.ops.rasterize.tile_overlap_counts": _BINNING,
        "NAME tssplat_tpu.ops.rasterize.validate_tile_capacity": _BINNING,
        "NAME tssplat_tpu.ops.rasterize.overflow_checks_enabled":
            "a TPU backend probe; the port reads n_drop on the host",
        "NAME tssplat_tpu.ops.rasterize.emit_overflow_warning":
            "a TPU debug callback; the port reads n_drop on the host",
        "NAME tssplat_tpu.ops.rasterize.aa_halo_mode":
            "the port always runs K4/K5",
        "NAME tssplat_tpu.ops.rasterize.aa_halo_enabled":
            "the port always runs K4/K5",
        "NAME tssplat_tpu.ops.rasterize.antialias_silhouette_halo":
            "the port always runs K4/K5 (antialias_silhouette)",
        **{f"ARGS tssplat_tpu.ops.rasterize.winner_screen_rows: {a}":
           "the port's winner_screen_rows(tbl6, ids, g6_kernel) takes the "
           "per-face screen table" for a in ("pos_clip", "tri", "edge_nbrs",
                                             "g_kernel", "corner")},
        **{f"ARGS tssplat_tpu.ops.rasterize.{f}: {a}": r
           for f, args in (("rasterize", ("tri", "chunk", "ids", "method",
                                          "corner", "drops_out")),
                           ("rasterize_silhouette", ("tri", "method",
                                                     "corner", "drops_out")),
                           ("rasterize_silhouette_with_rows",
                            ("tri", "method", "corner", "drops_out")),
                           ("interpolate", ("tri", "corner")))
           for a in args
           for r in [{"tri": _CORNER, "corner": _CORNER, "ids": _VIS,
                      "method": _VIS, "drops_out": _DROPS,
                      "chunk": "the brute-force search's chunk; the port's "
                               "visibility is binned"}[a]]},
        "ARGS tssplat_tpu.ops.rasterize.antialias: color":
            "the colour antialias is antialias_color",
        "ARGS tssplat_tpu.ops.rasterize.antialias: tri": _CORNER,
        "ARGS tssplat_tpu.ops.rasterize.antialias: corner": _CORNER,
        "ARGS tssplat_tpu.ops.rasterize.antialias: g_precomputed":
            "precomputed rows go to antialias_rows / antialias_silhouette",
        "ARGS tssplat_tpu.ops.rasterize.antialias: row_valid":
            "a slab's rows are the renderers' viewport=",
    },
    "parallel": {
        **{f"EXPORT tssplat_tpu.parallel.{n}": _RANKS
           for n in ("batch_spec_for", "chunked_view_sharding",
                     "make_device_mesh", "replicate_multihost",
                     "replicated_sharding", "shard_spatial_batch",
                     "spatial_mesh", "spatial_silhouette_loss",
                     "view_sharding")},
        **{f"NAME tssplat_tpu.parallel.mesh.{n}": _RANKS
           for n in ("make_device_mesh", "view_sharding",
                     "replicated_sharding", "chunked_view_sharding",
                     "batch_spec_for", "replicate_multihost")},
        **{f"NAME tssplat_tpu.parallel.spatial.{n}": _RANKS
           for n in ("shard_map", "spatial_mesh", "spatial_silhouette_loss",
                     "shard_spatial_batch")},
        "ARGS tssplat_tpu.parallel.mesh.shard_batch: mesh": _RANKS,
        "ARGS tssplat_tpu.parallel.spatial.spatial_geometry_loss: mesh":
            _RANKS,
        "ARGS tssplat_tpu.parallel.spatial.spatial_geometry_loss: method":
            _VIS,
        "ARGS tssplat_tpu.parallel.spatial.shard_spatial_train_batch: mesh":
            _RANKS,
    },
    "render": {
        "ARGS tssplat_tpu.render.pipeline.render_views: chunk":
            "the brute-force search's chunk; the port's visibility is "
            "binned",
        "ARGS tssplat_tpu.render.pipeline.render_views: rast_ids": _VIS,
    },
    "utils": {
        f"{kind} tssplat_tpu.utils.{where}PrintExecTime":
            "a printing timer that nothing called; the port's spans "
            "(utils/profiling.py span) name the step's layers in the "
            "profiler's trace"
        for kind, where in (("EXPORT", ""), ("NAME", "profiling."))
    },
    "train": {
        "ARGS tssplat_tpu.train.make_train_step: fitting_stage":
            "the stage follows from material_fn",
        "ARGS tssplat_tpu.train.make_train_step: batch_sharding": _RANKS,
        "ARGS tssplat_tpu.train.make_train_step: replicated_sharding": _RANKS,
        "ARGS tssplat_tpu.train.make_train_step: sp_mesh": _RANKS,
    },
}


def _own_public(mod):
    return {n: o for n, o in vars(mod).items()
            if not n.startswith("_")
            and (inspect.isfunction(o) or inspect.isclass(o))
            and getattr(o, "__module__", None) == mod.__name__}


def _missing_args(jax_obj, port_obj, label):
    try:
        want = inspect.signature(jax_obj).parameters
        have = inspect.signature(port_obj).parameters
    except (TypeError, ValueError):
        return []
    return [f"ARGS {label}: {a}" for a in want if a not in have]


def _diff(top: str):
    """The JAX names, methods and arguments under ``tssplat_tpu.<top>``
    with no counterpart in the port."""
    jax_top = importlib.import_module(f"tssplat_tpu.{top}")
    mods = [(jax_top.__name__, hasattr(jax_top, "__path__"))]
    if hasattr(jax_top, "__path__"):
        mods += [(m.name, m.ispkg) for m in pkgutil.walk_packages(
            jax_top.__path__, jax_top.__name__ + ".")]
    out = []
    for name, is_pkg in mods:
        jm = importlib.import_module(name)
        port_name = name.replace("tssplat_tpu", "tssplat_torch", 1)
        try:
            tm = importlib.import_module(port_name)
        except ModuleNotFoundError:
            out.append(f"MODULE {port_name}")
            continue
        if is_pkg:
            out += [f"EXPORT {name}.{n}" for n in getattr(jm, "__all__", [])
                    if not hasattr(tm, n)]
        for n, o in _own_public(jm).items():
            t = getattr(tm, n, None)
            if t is None:
                out.append(f"NAME {name}.{n}")
                continue
            out += _missing_args(o, t, f"{name}.{n}")
            if not inspect.isclass(o):
                continue
            for mn in vars(o):
                if mn.startswith("_") and mn != "__init__":
                    continue
                jm_attr = getattr(o, mn)
                if not callable(jm_attr):
                    continue
                if not hasattr(t, mn):
                    out.append(f"METHOD {name}.{n}.{mn}")
                    continue
                out += _missing_args(jm_attr, getattr(t, mn),
                                     f"{name}.{n}.{mn}")
    return sorted(set(out))


TOPS = sorted(m.name for m in pkgutil.iter_modules(tssplat_tpu.__path__))


@pytest.mark.parametrize("top", TOPS)
def test_public_api_has_counterparts(top):
    """The differences under tssplat_tpu.<top> are exactly the listed
    ones."""
    assert _diff(top) == sorted(NO_COUNTERPART.get(top, {}))


def test_every_listed_difference_names_a_known_place():
    assert set(NO_COUNTERPART) <= set(TOPS)
