"""The geometry step replayed as CUDA graphs.

``make_train_step`` (``train.py``) splits the geometry step of one batch on
one rank into three parts:

  - the front of the binning (``render.pipeline.render_front``): the clip
    positions, the face table, each face's tiles and the pair total, of
    shapes fixed by the views and faces;
  - the back of the binning (``binning.capped_back``), eager: the host
    reads the pair total, the step's one wait, to size the expansion and
    its sort, and writes the bins' fixed-shape candidate lists;
  - the body: the visibility kernel on the bins, the render, the losses,
    the energy, ``torch.autograd.grad``, the optimizer and the best
    snapshot, on the iteration's host values (``train.step_scalars``: the
    energy ramp's c1 and c2, the iteration for the best snapshot), staged
    through pinned memory with no wait. It reads no other host value but
    the barrier's order, and its shapes are fixed by the state's, the
    batch's and the bins'.

On a CUDA device ``GraphedStep`` captures the front and the body, each as a
graph, once for each key (the barrier's order, the shapes, the addresses of
the batch tensors it reads in place), and replays them around the eager
back. A key's first call runs the step eagerly, the body on a side stream
(its warm-up: kernel builds, lazy initialisation); its second captures
both graphs and replays them; every later call replays. Each call copies
the state's leaves and the batch's tensors into the graphs' static inputs
(a batch tensor that its loader marks as its reused output buffer,
``data.loader.REUSED``, is read in place and not copied), and returns
clones of the body's outputs, so no later replay writes a tensor a caller
keeps. A replay adds the kernel launches its capture recorded to
``raster_kernels.launch_counts()`` (a capture launches nothing), so the
counts stay a run's launches.

The step runs eagerly, the same arithmetic on fresh tensors, wherever a
graph cannot hold it: off CUDA, on K1's uncapped bins (their length is the
data's), under the NaN trap or anomaly mode, and where a profiler records
at the call that would capture.
"""

from __future__ import annotations

from typing import Callable, Sequence

import torch
from torch.utils._pytree import tree_flatten, tree_unflatten

from .data.loader import REUSED
from .ops import raster_kernels as rk
from .ops.binning import CappedBins
from .utils import debug
from .utils.profiling import span


class _Graphs:
    """One key's static inputs and, once captured, its two graphs."""

    def __init__(self, leaves, spec, batch: dict, bins: CappedBins,
                 scal: torch.Tensor):
        self.leaves, self.spec = leaves, spec
        self.batch, self.bins, self.scal = batch, bins, scal
        self.front = None            # the front graph's outputs
        self.front_graph = self.body_graph = None
        self.outputs = None          # (leaves, spec) of the body's result
        self.launches = ()           # (kernel wrapper, launches) a replay


class GraphedStep:
    """``(state, batch, it) -> (state, outs)``: the binning of ``bins_fn``
    (``front_fn`` then ``back_fn``) and ``body`` on the host values of
    ``scalars_fn``, replayed from CUDA graphs where it can be (see the
    module doc).

    ``bins_fn(params, batch)``: the step's bins, eagerly;
    ``front_fn(params, batch)``: the first half of the capped layout's
    bins, or None for K1's; ``back_fn(front, out=None)``: the bins of a
    front, written into the tensors of the bins ``out`` where given;
    ``scalars_fn(it, device, out=None)``: the iteration's host values on
    the device; ``body(state, batch, bins, scalars, it)``; ``keys``: the
    batch entries the step reads; ``order(it)``: the one host value the body
    branches on. ``replays`` counts the body graph's replays."""

    def __init__(self, bins_fn: Callable, front_fn: Callable,
                 back_fn: Callable, scalars_fn: Callable, body: Callable,
                 keys: Sequence[str], order: Callable[[int], int]):
        self.bins_fn, self.front_fn, self.back_fn = bins_fn, front_fn, back_fn
        self.scalars_fn, self.body = scalars_fn, body
        self.keys, self.order = tuple(keys), order
        self.replays = 0
        self._graphs = {}
        self._stream = self._pool = None

    def eager(self, state, batch: dict, it: int):
        """The step without a graph: the binning, the host values and the
        body, on fresh tensors (what the graphs replay)."""
        batch = {k: batch[k] for k in self.keys}
        return self.body(state, batch, self.bins_fn(state.params, batch),
                         self.scalars_fn(it, state.params.device), it)

    def __call__(self, state, batch: dict, it: int):
        if (not state.params.is_cuda or debug.debug_nans_enabled()
                or debug.anomaly_enabled()):
            return self.eager(state, batch, it)
        batch = {k: batch[k] for k in self.keys}
        leaves, spec = tree_flatten(state)
        key = (self.order(it), str(spec),
               tuple((tuple(t.shape), t.dtype) for t in leaves),
               tuple((k, tuple(t.shape), t.dtype,
                      t.data_ptr() if getattr(t, REUSED, False) else None)
                     for k, t in batch.items()))
        g = self._graphs.get(key)
        if g is None:
            return self._warm_up(key, leaves, spec, state, batch, it)
        if g.body_graph is None and torch.autograd._profiler_enabled():
            return self.eager(state, batch, it)
        torch._foreach_copy_(g.leaves, leaves)
        for k, t in batch.items():
            if g.batch[k] is not t:
                g.batch[k].copy_(t)
        # staged first: after the binning's wait the host has the back alone
        # to do before the body's replay
        self.scalars_fn(it, state.params.device, out=g.scal)
        if g.body_graph is None:
            self._capture(g, it)
        else:
            with span("tssplat.visibility"), span("tssplat.binning"):
                g.front_graph.replay()
                self.back_fn(g.front, g.bins)
        with span("tssplat.graph"):
            g.body_graph.replay()
        self.replays += 1
        for fn, n in g.launches:
            fn.launches += n
        out = [t.clone() for t in g.outputs[0]]
        return tree_unflatten(out, g.outputs[1])

    def _warm_up(self, key, leaves, spec, state, batch: dict, it: int):
        """A key's first call: the step run eagerly, the body on the side
        stream the captures use, and the static inputs of its graphs (the
        bins' and the host values' tensors are this call's)."""
        front = self.front_fn(state.params, batch)
        if front is None:
            return self.eager(state, batch, it)
        bins = self.back_fn(front)
        scal = self.scalars_fn(it, state.params.device)
        self._graphs[key] = _Graphs(
            [t.clone() for t in leaves], spec,
            {k: t if getattr(t, REUSED, False) else t.clone()
             for k, t in batch.items()}, bins, scal)
        if self._stream is None:
            self._stream = torch.cuda.Stream(state.params.device)
        main = torch.cuda.current_stream()
        self._stream.wait_stream(main)
        with torch.cuda.stream(self._stream):
            # on the call's own state and batch: what it returns is no
            # static input
            out = self.body(state, batch, bins, scal, it)
        main.wait_stream(self._stream)
        return out

    def _capture(self, g: _Graphs, it: int) -> None:
        """Capture the front and the body on ``g``'s static inputs, running
        the back between them. The graphs of this step share one memory
        pool: they replay one at a time, the front's outputs live while the
        body runs, and each body's outputs are cloned before the next
        replay, so one graph's temporaries may lie where another's outputs
        do."""
        before = [fn.launches for fn in rk.KERNELS]
        params = tree_unflatten(g.leaves, g.spec).params
        g.front_graph = torch.cuda.CUDAGraph()
        with span("tssplat.graph_capture"):
            with torch.cuda.graph(g.front_graph, pool=self._pool,
                                  stream=self._stream):
                g.front = self.front_fn(params, g.batch)
        self._pool = g.front_graph.pool()
        with span("tssplat.visibility"), span("tssplat.binning"):
            g.front_graph.replay()
            g.bins = self.back_fn(g.front, g.bins)
        g.body_graph = torch.cuda.CUDAGraph()
        with span("tssplat.graph_capture"):
            with torch.cuda.graph(g.body_graph, pool=self._pool,
                                  stream=self._stream):
                g.outputs = tree_flatten(self.body(
                    tree_unflatten(g.leaves, g.spec), g.batch, g.bins, g.scal,
                    it))
        g.launches = tuple((fn, fn.launches - n)
                           for fn, n in zip(rk.KERNELS, before)
                           if fn.launches != n)
        for fn, n in zip(rk.KERNELS, before):
            fn.launches = n
