"""A method config into a runnable pipeline and trainer (counterpart of
``nerfstudio_tpu/pipelines/factory.py``): the dataparser's splits as
the method's datasets (images, or with depths, class labels or SDF
priors), the datamanager, the model at the scene's aabb (and the dataset's
classes) with its parameters drawn from ``config.seed``, the per-group
Adam, the auxiliary state and hook (nerfacto's occupancy update, TensoRF's
grid upsampling), on the device ``config.machine`` names."""

from __future__ import annotations

from pathlib import Path
from typing import Tuple

import torch

from nerfstudio_torch.data.datamanagers import DeviceCacheDataManager
from nerfstudio_torch.data.datasets import DepthDataset, InputDataset, SDFDataset, SemanticDataset
from nerfstudio_torch.engine.optimizers import PerGroupAdam
from nerfstudio_torch.engine.trainer import Trainer
from nerfstudio_torch.parallel import mesh
from nerfstudio_torch.pipelines.base_pipeline import TrainState, VanillaPipeline


def _eval_split_candidates(parser) -> Tuple[str, ...]:
    # the Blender format ships test and val splits; the nerfstudio parser
    # takes any name other than "train" as its eval split
    return ("test", "val") if "blender" in type(parser).__name__.lower() else ("val", "test")


# the dataset class a method names (reference :41-52)
DATASETS = {"input": InputDataset, "depth": DepthDataset, "semantic": SemanticDataset, "sdf": SDFDataset}


def build_datasets(config):
    """(train dataset, eval dataset, the train split's parser outputs)
    (reference :25-52), of the class ``config.dataset`` names."""
    cls = DATASETS[config.dataset]
    if config.data is not None:
        config.dataparser.data = Path(config.data)
    parser = config.dataparser.setup()
    train_out = parser.get_dataparser_outputs("train")
    eval_out = train_out
    for split in _eval_split_candidates(parser):
        try:
            eval_out = parser.get_dataparser_outputs(split)
            break
        except FileNotFoundError:
            continue
    return cls(train_out), cls(eval_out), train_out


def scene_aabb(outputs) -> Tuple[Tuple[float, ...], ...]:
    return tuple(tuple(float(v) for v in row) for row in outputs.scene_box.aabb.tolist())


def build_pipeline(config) -> Tuple[VanillaPipeline, TrainState, object]:
    """(pipeline, train state, config) of a ray-based method (reference
    :55-90). A semantic dataset's classes set the model's
    ``num_semantic_classes``. The model's parameters are drawn from a
    generator seeded with ``config.seed``, the same on every rank of a
    process group, whose ranks share the global batch of
    ``train_num_rays_per_batch`` rays (it must divide by their count)."""
    device = config.machine.device()
    world = mesh.world_size()
    if config.datamanager.train_num_rays_per_batch % world:
        raise ValueError(f"train_num_rays_per_batch {config.datamanager.train_num_rays_per_batch} does not divide "
                         f"over {world} ranks")
    train_ds, eval_ds, train_out = build_datasets(config)
    datamanager = DeviceCacheDataManager.from_datasets(config.datamanager, train_ds, eval_ds, device)
    sem = getattr(train_ds, "semantics", None)
    if sem is not None and sem.classes and hasattr(config.model, "num_semantic_classes"):
        config.model.num_semantic_classes = len(sem.classes)
    model_cls = config.model._target
    model = config.model.setup(scene_aabb=scene_aabb(train_out), num_train_data=len(train_ds), device=device).train()
    model.reset_parameters(torch.Generator(device=device).manual_seed(config.seed))
    pipeline = VanillaPipeline(datamanager, model)
    aux = None
    if hasattr(model_cls, "make_upsample_hook"):
        pipeline.aux_update_fn = model_cls.make_upsample_hook(model, config.model)
    if hasattr(model_cls, "init_aux"):
        aux = model_cls.init_aux(model, config.model, device)
        pipeline.aux_update_fn = model_cls.make_aux_update_fn(model, config.model)
    return pipeline, TrainState(PerGroupAdam(config.optimizers, model), aux=aux), config


def build_trainer(config) -> Trainer:
    """The trainer of a ray-based method, resumed from
    ``config.trainer.load_dir`` when set (reference :93-108)."""
    pipeline, state, config = build_pipeline(config)
    model_cls = config.model._target
    trainer = Trainer(config.trainer, pipeline, state, lambda step: model_cls.step_kwargs(step, config.model),
                      seed=config.seed)
    if config.trainer.load_dir is not None:
        trainer.load_checkpoint()
    return trainer
