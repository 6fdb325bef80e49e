"""DatasetEngine: task-keyed train/val dataloader factory.

The port's own copy of ``unirestore_tpu/data/engine.py`` (numpy only; the port imports
nothing of the JAX package).

Mirrors the reference's datamodule surface (data/__init__.py:59-372): the
same YAML init args (task, train{type,resolution,batch_size},
val{type,val_list,batch_size}, crp_mode, num_workers, prefetch_factor) and
the same dataset wiring per task, including the MTL weighted mixture
[ImageNet-C x0.2, FoggyCityscapes x10, DF2K+OST x1].
"""

from __future__ import annotations

from . import datasets as DS
from .loader import DataLoader, WeightedMixture
from .manifest import DATASET_DICT, ImageData


class DatasetEngine:
    def __init__(self, task: str, train: dict | None = None,
                 val: dict | None = None, crp_mode: str = "common",
                 num_workers: int = 4, prefetch_factor: int = 2,
                 dataset_dict: dict | None = None, seed: int = 0):
        self.task = task
        self.train = train or {}
        self.val = val or {}
        self.resolution = self.train.get("resolution", 512)
        self.crp_mode = crp_mode
        self.num_workers = num_workers
        self.prefetch_factor = prefetch_factor
        self.dd = dataset_dict or DATASET_DICT
        self.seed = seed

    # -- builders ----------------------------------------------------------

    def _imgdata(self, name, split):
        return ImageData(self.dd[name][split])

    def train_dataloader(self) -> DataLoader:
        t = self.task
        bs = self.train.get("batch_size", 1)
        kw = dict(resolution=self.resolution, is_train=True,
                  crp_mode=self.crp_mode, seed=self.seed)
        if t == "mtl":
            if self.train.get("type") != "all":
                raise KeyError(f"MTL train type {self.train.get('type')!r} "
                               "not defined")
            sets = [
                DS.CLSCorruptDataset(self._imgdata("ImageNet", "train"), **kw),
                DS.CityscapesCorruptDataset(
                    self._imgdata("FoggyCityscapes", "train"), **kw),
                DS.IRCorruptDataset(self._imgdata("DIVF2KOST", "train"), **kw),
            ]
            mixture = WeightedMixture(sets, weights=[0.2, 10, 1],
                                      seed=self.seed)
            return DataLoader(mixture, batch_size=bs, drop_last=True,
                              num_workers=self.num_workers,
                              prefetch=self.prefetch_factor, seed=self.seed)
        if t == "ir":
            if self.train.get("type") != "div2kost":
                raise NotImplementedError(self.train.get("type"))
            ds = DS.IRCorruptDataset(self._imgdata("DIVF2KOST", "train"), **kw)
            mixture = WeightedMixture([ds], weights=[1], seed=self.seed)
            return DataLoader(mixture, batch_size=bs, drop_last=True,
                              num_workers=self.num_workers,
                              prefetch=self.prefetch_factor, seed=self.seed)
        if t == "cls":
            ds = DS.CLSCorruptDataset(self._imgdata("ImageNet", "train"), **kw)
        elif t == "seg":
            ds = DS.CityscapesCorruptDataset(
                self._imgdata("FoggyCityscapes", "train"), **kw)
        elif t == "det":
            from .datasets_det import CoCoCorruptDataset
            ds = CoCoCorruptDataset(self._imgdata("COCO", "train"), **kw)
        else:
            raise KeyError(f"unknown task {t!r}")
        return DataLoader(ds, batch_size=bs, shuffle=True, drop_last=True,
                          num_workers=self.num_workers,
                          prefetch=self.prefetch_factor, seed=self.seed)

    def val_dataloader(self) -> DataLoader:
        t = self.task
        bs = self.val.get("batch_size", 1)
        vtype = self.val.get("type", "val")
        kw = dict(resolution=self.resolution, is_train=False, seed=self.seed)

        def loader(ds):
            return DataLoader(ds, batch_size=bs, shuffle=False,
                              drop_last=False, num_workers=self.num_workers,
                              prefetch=self.prefetch_factor, seed=self.seed)

        if t == "mtl":
            sets = [
                DS.IRPairDataset(self._imgdata("DIVF2KOST", "val"), **kw),
                DS.CLSPairDataset(self._imgdata("ImageNet", "val"), **kw),
                DS.CityscapesPairDataset(self._imgdata("Cityscapes", "val"),
                                         **kw),
            ]
            return [loader(s) for s in sets]
        if t == "ir":
            if vtype == "val":
                return loader(DS.IRPairDataset(
                    self._imgdata("DIVF2KOST", "val"), **kw))
            cls_by_type = {"pair": DS.IRPairDataset,
                           "real": DS.IRRealDataset,
                           "noise": DS.IRNoiseDataset}
            if vtype not in cls_by_type:
                raise NotImplementedError(vtype)
            loaders = []
            # sigma protocol (reference dataset_ir.py:259-267): the AWGN
            # eval runs at sigma in {15, 25, 50}. val.noise_sigma may be a
            # single level or a list (one loader per level per dataset);
            # default 50 matches the reference datamodule's pin
            # (data/__init__.py:273).
            sigmas = self.val.get("noise_sigma", 50)
            if not isinstance(sigmas, (list, tuple)):
                sigmas = [sigmas]
            for name in self.val.get("val_list", []):
                split = "test" if "test" in self.dd[name] else "val"
                if vtype == "noise":
                    for s in sigmas:
                        loaders.append(loader(cls_by_type[vtype](
                            self._imgdata(name, split), **kw,
                            noise_sigma=s)))
                else:
                    loaders.append(loader(cls_by_type[vtype](
                        self._imgdata(name, split), **kw)))
            return loaders if len(loaders) != 1 else loaders[0]
        if t == "cls":
            name = "CUB" if vtype == "CUB" else "ImageNet"
            return loader(DS.CLSPairDataset(self._imgdata(name, "val"), **kw))
        if t == "seg":
            if vtype == "val":
                return loader(DS.CityscapesPairDataset(
                    self._imgdata("Cityscapes", "val"), **kw))
            if vtype in ("fog1", "fog2", "fog3"):
                kw2 = dict(kw)
                kw2["crp_mode"] = vtype
                return loader(DS.CityscapesPairDataset(
                    self._imgdata("FoggyCityscapes", "val"), **kw2))
            if vtype in ("Foggy_Zurich", "ACDC"):
                return loader(DS.SEGRealDataset(
                    self._imgdata(vtype, "val"), **kw))
            if vtype in ("ACDC_fog", "ACDC_rain", "ACDC_snow", "ACDC_night"):
                return loader(DS.SEGRealDataset(
                    self._imgdata("ACDC", "val_" + vtype.split("_")[-1]),
                    **kw))
            raise NotImplementedError(vtype)
        if t == "det":
            from .datasets_det import CoCoPairDataset, CoCoRealDataset
            if vtype == "val":
                return loader(CoCoPairDataset(self._imgdata("COCO", "val"),
                                              **kw))
            if vtype == "RTTS":
                return loader(CoCoRealDataset(self._imgdata("RTTS", "test"),
                                              ann="RTTS", **kw))
            raise NotImplementedError(vtype)
        raise KeyError(f"unknown task {t!r}")
