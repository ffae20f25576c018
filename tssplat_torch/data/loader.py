"""View-batch data loader (the port of ``tssplat_tpu/data/loader.py``;
reference data/dataloader.py:13-163): the whole dataset on the device,
per-iteration batch index lists computed up front and split by
(world_size, rank).

  - GT RGB composited over the background by alpha, alpha kept
    (``lerp(bg, rgb, a)``, dataloader.py:49-50);
  - the full view list reshuffled every iteration by Python's ``random``
    seeded once at 1234, after replaying the reference's warm-up shuffle
    (dataloader.py:83-97): the batch order is the JAX package's, index for
    index;
  - rank slice ``[rank*bs : min((rank+1)*bs, n)]`` of each iteration's
    shuffle, reused for every forward of the iteration (dataloader.py:
    99-106); without a ``rank`` in the config, the process's rank
    (``utils/env.py get_rank``) where ``world_size`` > 1, else 0;
  - ``num_forward_per_iter = ceil(n / (bs * world_size))``.
"""

from __future__ import annotations

import random
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from ..config import DATALOADERS, parse_structured
from ..device import DeviceLike, resolve_device
from ..utils.env import get_rank
from ..utils.profiling import span
from .datasets import (ArrayDataset, BlenderImgDataset, MitsubaImgDataset,
                       Wonder3DImgDataset)


class ViewDataLoader:
    """Batches of dataset views on ``device`` (``cuda`` unless the caller
    asks for the CPU)."""

    @dataclass
    class Config:
        batch_size: int = 1
        total_num_iter: int = 1
        world_size: int = 1
        rank: Optional[int] = None
        dataset_config: Optional[dict] = None

    dataset_cls = None

    def __init__(self, cfg=None, dataset=None, device: DeviceLike = None):
        self.cfg = parse_structured(self.Config, cfg)
        self.device = resolve_device(device)
        if dataset is None:
            if self.dataset_cls is None:
                raise ValueError("no dataset class / instance given")
            dataset = self.dataset_cls(self.cfg.dataset_config)
        self.dataset = dataset
        self.prepare_data()

    def __len__(self):
        return len(self.dataset)

    def _to_device(self):
        ds = self.dataset
        dev = self.device

        def f32(arrays):
            return torch.as_tensor(np.stack(arrays), dtype=torch.float32,
                                   device=dev)

        img = f32(ds.all_tgt_imgs)
        bg = f32(ds.bgs)
        # composite GT over the background by alpha, keep the alpha channel
        rgb = bg + (img[..., 0:3] - bg) * img[..., 3:4]
        self.data_all = {
            "mv": f32(ds.all_mv_mats),
            "mvp": f32(ds.all_mvp_mats),
            "campos": f32(ds.all_campos),
            "resolution": ds.resolution,
            "spp": ds.spp,
            "img": torch.cat([rgb, img[..., 3:4]], dim=-1),
            "n": f32(ds.all_tgt_ns),
            "d": f32(ds.all_tgt_ds),
            "background": bg,
        }

    def prepare_data(self):
        self._to_device()
        n = len(self.dataset)
        c = self.cfg
        per_iter = c.batch_size * c.world_size
        self.num_forward_per_iter = n // per_iter + (1 if n % per_iter else 0)

        rng = random.Random()
        rng.seed(1234)
        # the reference shuffles an appended index list once after seeding
        # (dataloader.py:83-90); replayed to keep the RNG stream identical
        appended = self.num_forward_per_iter * per_iter * c.total_num_iter
        warmup = [i % n for i in range(appended)]
        rng.shuffle(warmup)

        self.batch_list = []
        for _ in range(c.total_num_iter):
            index_list = list(range(n))
            rng.shuffle(index_list)
            batch_iter = []
            for _fw in range(self.num_forward_per_iter):
                per_rank = []
                for rank_i in range(c.world_size):
                    start = rank_i * c.batch_size
                    end = min(start + c.batch_size, n)
                    per_rank.append(index_list[start:end])
                batch_iter.append(per_rank)
            self.batch_list.append(batch_iter)

    @property
    def rank(self) -> int:
        """The slice this loader serves by default: the config's rank, else
        the process's where world_size > 1, else 0."""
        if self.cfg.rank is not None:
            return int(self.cfg.rank)
        return get_rank() if self.cfg.world_size > 1 else 0

    def batch_indices(self, it: int, forward_id: int,
                      rank: Optional[int] = None) -> np.ndarray:
        r = self.rank if rank is None else rank
        return np.asarray(self.batch_list[it][forward_id][r], np.int32)

    def __call__(self, it: int, forward_id: int, rank: Optional[int] = None):
        with span("tssplat.loader"):
            ids = self.batch_indices(it, forward_id, rank)
            idx = torch.as_tensor(ids, dtype=torch.int64, device=self.device)
            d = self.data_all
            return {
                "mv": d["mv"][idx],
                "mvp": d["mvp"][idx],
                "campos": d["campos"][idx],
                "resolution": d["resolution"],
                "spp": d["spp"],
                "img": d["img"][idx],
                "background": d["background"][idx],
                "n": d["n"][idx],
                "d": d["d"][idx],
                "view_idx": idx.to(torch.int32),
            }


@DATALOADERS.register("MistubaImgDataLoader")      # sic — reference name
@DATALOADERS.register("MitsubaImgDataLoader")
class MitsubaImgDataLoader(ViewDataLoader):
    dataset_cls = MitsubaImgDataset


@DATALOADERS.register("BlenderImgDataLoader")
class BlenderImgDataLoader(ViewDataLoader):
    dataset_cls = BlenderImgDataset


@DATALOADERS.register("Wonder3DDataLoader")
class Wonder3DDataLoader(ViewDataLoader):
    dataset_cls = Wonder3DImgDataset


@DATALOADERS.register("ArrayDataLoader")
class ArrayDataLoader(ViewDataLoader):
    """Loader over an in-memory ArrayDataset (synthetic targets, tests)."""
    dataset_cls = ArrayDataset

    def __init__(self, cfg=None, dataset=None, device: DeviceLike = None,
                 **arrays):
        if dataset is None and arrays:
            dataset = ArrayDataset(**arrays)
        super().__init__(cfg, dataset=dataset, device=device)
