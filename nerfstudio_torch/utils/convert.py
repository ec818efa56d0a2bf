"""Load the JAX package's parameters and occupancy grids into the port.

Takes nested dicts of numpy arrays (``jax.device_get`` of a flax params
tree or a ``TrainState`` works as is) and imports no jax. Dense kernels
``(in, out)`` become ``weight (out, in)`` (the SDF field's weight-normed
kernels too, beside their ``scale``); hash tables keep their ``(L, S,
128)`` layout, block and flat alike; list members such as ``layers_0``,
``glin_0`` or ``proposal_networks_1`` become ``layers.0``, ``glin.0``,
``proposal_networks.1``; a field head's one ``Dense_0`` (the semantic
head's, the predicted-normal head's, the NeRF field's density and colour
heads') becomes its ``layer``;
TensoRF's ``plane_coef`` and ``line_coef`` keep their layouts; ``LearnedVariance``'s scalar stays a
scalar. Every leaf must land on exactly one parameter: anything left
over on either side raises. ``splat_state_from_jax`` carries a splatfacto
train state whole: gaussians, densification state and Adam moments.
``trainer_checkpoint_from_jax`` turns a JAX train state (the ``TrainState``
of nerfacto, neus-facto or instant-ngp, whose aux is the occupancy grid, or
a ``SplatTrainState``) into the port's checkpoint payload, so a JAX-trained
run resumes in the port;
``dataparser_outputs_from_jax`` turns the JAX parser's outputs into the
port's."""

from __future__ import annotations

import dataclasses
import re
from typing import Any, Dict, Iterator, Mapping, Optional, Tuple

import numpy as np
import torch

from nerfstudio_torch.ops.occupancy import OccupancyGridState

_LIST_MEMBER = re.compile(r"(layers|glin|clin|proposal_networks)_(\d+)")


def _leaves(tree: Mapping[str, Any], prefix: Tuple[str, ...] = ()) -> Iterator[Tuple[Tuple[str, ...], Any]]:
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _leaves(v, prefix + (str(k),))
        else:
            yield prefix + (str(k),), v


def _torch_name(path: Tuple[str, ...]) -> Tuple[str, bool]:
    """(state-dict key, whether the array is a dense kernel to transpose)."""
    *modules, leaf = path
    parts = []
    for m in modules:
        match = _LIST_MEMBER.fullmatch(m)
        if m == "Dense_0" and parts and parts[-1].startswith(("field_head_", "field_output_")):
            parts.append("layer")  # FieldHead's compact Dense
        else:
            parts += [match[1], match[2]] if match else [m]
    if leaf == "kernel":
        return ".".join(parts + ["weight"]), True
    if leaf in ("bias", "hash_table", "pose_adjustment", "plane_coef", "line_coef"):
        return ".".join(parts + [leaf]), False
    if (leaf == "scale" and modules and modules[-1].startswith("glin_")) or (
        leaf == "variance" and modules and modules[-1] == "deviation_network"
    ):  # WNDense's scale, LearnedVariance's scalar
        return ".".join(parts + [leaf]), False
    if leaf == "embedding" and modules and modules[-1] == "embedding":
        return ".".join(parts + ["weight"]), False
    raise ValueError(f"no port parameter for JAX leaf {'/'.join(path)}")


# Created by the reference only when first used, i.e. in training: an eval
# model's tree has no camera optimizer. The port's model always has it, and
# a tree without it loads the reference's init, zeros.
_TRAIN_ONLY = ("camera_optimizer.pose_adjustment",)


def params_from_jax(tree: Mapping[str, Any], model: Optional[torch.nn.Module] = None) -> Dict[str, torch.Tensor]:
    """A flax params tree (with or without its ``params`` collection key) ->
    the port's state dict. With ``model``, the keys and shapes must match its
    state dict exactly, except that a tree without the training-only camera
    optimizer gets its zero init."""
    if set(tree) == {"params"}:
        tree = tree["params"]
    state: Dict[str, torch.Tensor] = {}
    for path, leaf in _leaves(tree):
        name, transpose = _torch_name(path)
        if name in state:
            raise ValueError(f"two JAX leaves map to {name}")
        arr = np.asarray(leaf, dtype=np.float32)
        state[name] = torch.from_numpy(np.array(arr.T if transpose else arr, order="C", copy=True))
    if model is not None:
        expected = model.state_dict()
        for k in _TRAIN_ONLY:
            if k in expected and k not in state:
                state[k] = torch.zeros(expected[k].shape, dtype=torch.float32)
        missing = sorted(set(expected) - set(state))
        extra = sorted(set(state) - set(expected))
        if missing or extra:
            raise ValueError(f"parameter mismatch: missing {missing}, left over {extra}")
        for k, v in state.items():
            if tuple(v.shape) != tuple(expected[k].shape):
                raise ValueError(f"{k}: JAX shape {tuple(v.shape)} vs port {tuple(expected[k].shape)}")
    return state


def occupancy_from_jax(state: Any) -> OccupancyGridState:
    """The JAX ``OccupancyGridState`` (or a dict of its fields) -> the port's
    flat grid. The reference's row-packed probe views are checked against
    the flat arrays they were packed from and dropped."""
    if dataclasses.is_dataclass(state):
        fields = {f.name: getattr(state, f.name) for f in dataclasses.fields(state)}
    else:
        fields = dict(state)
    known = {"densities", "binary", "binary_rows", "density_rows", "aabb", "resolution"}
    if set(fields) != known:
        raise ValueError(
            f"occupancy state fields: missing {sorted(known - set(fields))}, "
            f"left over {sorted(set(fields) - known)}"
        )
    res = int(fields["resolution"])
    densities = np.asarray(fields["densities"], dtype=np.float32)
    binary = np.asarray(fields["binary"], dtype=bool)
    for rows_name, flat in (("binary_rows", binary), ("density_rows", densities)):
        rows = np.asarray(fields[rows_name], dtype=np.float32)
        packed = np.zeros((res * res, max(res, 128)), np.float32)
        packed[:, :res] = flat.reshape(res * res, res)
        if rows.shape != packed.shape or not np.array_equal(rows, packed):
            raise ValueError(f"{rows_name} is not the packed view of its flat array")
    return OccupancyGridState(
        densities=torch.from_numpy(densities.copy()),
        binary=torch.from_numpy(binary.copy()),
        aabb=torch.from_numpy(np.asarray(fields["aabb"], dtype=np.float32).copy()),
        resolution=res,
    )


def _fields(obj: Any) -> Dict[str, Any]:
    """A mapping, a named tuple (optax's states) or a dataclass as a dict."""
    if isinstance(obj, Mapping):
        return dict(obj)
    if hasattr(obj, "_asdict"):
        return obj._asdict()
    return {f.name: getattr(obj, f.name) for f in dataclasses.fields(obj)}


def _tensor(x: Any, dtype=torch.float32) -> torch.Tensor:
    return torch.from_numpy(np.array(x, copy=True)).to(dtype)


def splat_state_from_jax(state: Any):
    """The JAX ``SplatTrainState`` (numpy leaves, e.g. ``jax.device_get`` of
    it) -> (params, ``SplatAux``, Adam moments, step) of the port, for
    ``SplatPipeline.state_from``: the six gaussian arrays and, where the
    state has them, the per-image ``bilateral_grids`` and ``camera_opt``,
    in the order the port's init makes them. The moments are {array:
    (count, mu, nu)}, read from the per-array optax Adams of
    ``build_splat_optimizers``; the ``means`` schedule's count must equal
    its Adam's."""
    from nerfstudio_torch.models.splatfacto import GAUSSIAN_ARRAYS, IMAGE_ARRAYS, SplatAux

    fields = _fields(state)
    jparams = _fields(fields["params"])
    if not set(GAUSSIAN_ARRAYS) <= set(jparams) or not set(jparams) <= set(GAUSSIAN_ARRAYS + IMAGE_ARRAYS):
        raise ValueError(f"splat params {sorted(jparams)}: the port has {sorted(GAUSSIAN_ARRAYS)} and optionally "
                         f"{sorted(IMAGE_ARRAYS)}")
    params = {k: _tensor(jparams[k]) for k in GAUSSIAN_ARRAYS + IMAGE_ARRAYS if k in jparams}
    aux_fields = _fields(fields["aux"])
    aux = SplatAux(
        alive=_tensor(aux_fields["alive"], torch.bool),
        grad_accum=_tensor(aux_fields["grad_accum"]),
        grad_count=_tensor(aux_fields["grad_count"]),
        max_radii=_tensor(aux_fields["max_radii"]),
    )
    inner = fields["opt_state"].inner_states
    if set(inner) != set(params):
        raise ValueError(f"optimizer groups {sorted(inner)} vs params {sorted(params)}")
    moments = {}
    for name in params:
        adam, *schedule = inner[name].inner_state
        count = int(np.asarray(adam.count))
        for s in schedule:
            if "count" in getattr(s, "_fields", ()) and int(np.asarray(s.count)) != count:
                raise ValueError(f"{name}: schedule count {int(np.asarray(s.count))} vs Adam count {count}")
        moments[name] = (count, _tensor(adam.mu[name]), _tensor(adam.nu[name]))
    return params, aux, moments, int(np.asarray(fields["step"]))


def train_state_from_jax(state: Any, model: torch.nn.Module) -> Tuple[Dict[str, torch.Tensor], Optional[OccupancyGridState], int]:
    """The JAX ``TrainState`` (or a dict of its fields) -> (the port's state
    dict, its occupancy grid or None, the step). The optax state is not
    carried: the port's optimizer starts fresh, as ``bench.py``'s does."""
    fields = state if isinstance(state, Mapping) else {f.name: getattr(state, f.name) for f in dataclasses.fields(state)}
    aux = fields.get("aux")
    return (
        params_from_jax(fields["params"], model),
        None if aux is None else occupancy_from_jax(aux),
        int(np.asarray(fields["step"])),
    )


def _adam_states(tree: Any):
    """The (count, mu, nu) of every optax ``ScaleByAdamState`` in an optimizer
    state, and the largest schedule count beside them."""
    if hasattr(tree, "mu") and hasattr(tree, "nu") and hasattr(tree, "count"):
        return [tree]
    if isinstance(tree, Mapping):
        return [a for v in tree.values() for a in _adam_states(v)]
    if isinstance(tree, tuple):
        return [a for v in tree for a in _adam_states(v)]
    return []


def _present(tree: Mapping[str, Any]) -> Dict[str, Any]:
    """A masked optax tree without its ``MaskedNode`` (empty tuple) leaves."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, Mapping):
            if sub := _present(v):
                out[k] = sub
        elif not (isinstance(v, tuple) and len(v) == 0):
            out[k] = v
    return out


def trainer_checkpoint_from_jax(state: Any, model: Optional[torch.nn.Module] = None, optimizer: Any = None,
                                max_steps: int = 30000) -> Dict[str, Any]:
    """A JAX train state (numpy leaves) -> the port's checkpoint payload
    (``engine.trainer.write_checkpoint``): for a ``TrainState`` the
    model's state dict (``model`` gives the names and shapes), the per-group
    Adam moments and counts laid out as ``optimizer`` (the port's
    ``PerGroupAdam`` over ``model``) holds them, the occupancy grid and the
    step; for a ``SplatTrainState`` the gaussians, ``SplatAdam``'s state
    (means schedule over ``max_steps``), the densification state and the
    step. The generators' states are not carried: the resumed run draws
    from its own seed."""
    fields = _fields(state)
    if "means" in _fields(fields["params"]):
        from nerfstudio_torch.engine.optimizers import SplatAdam
        from nerfstudio_torch.engine.trainer import aux_state

        params, aux, moments, step = splat_state_from_jax(state)
        adam = SplatAdam({k: v.clone().requires_grad_(True) for k, v in params.items()}, max_steps)
        adam.load_moments(moments)
        return {"step": step, "params": params, "optimizer": adam.state_dict(), "aux": aux_state(aux),
                "generator": None, "datamanager": None}
    if model is None or optimizer is None:
        raise ValueError("a TrainState converts against the port's model and its PerGroupAdam")
    state_dict, grid, step = train_state_from_jax(state, model)
    inner = _fields(fields["opt_state"])["inner_states"]
    if set(inner) != set(optimizer.optimizers):
        raise ValueError(f"optimizer groups {sorted(inner)} vs the port's {sorted(optimizer.optimizers)}")
    name_of = {id(p): n for n, p in model.named_parameters()}
    groups, counts = {}, set()
    for group, opt in optimizer.optimizers.items():
        adams = _adam_states(inner[group])
        if len(adams) != 1:
            raise ValueError(f"group {group}: {len(adams)} Adam states")
        adam = adams[0]
        count = int(np.asarray(adam.count))
        counts.add(count)
        mu, nu = (params_from_jax(_present(_fields(x))) for x in (adam.mu, adam.nu))
        template = opt.state_dict()
        names = [name_of[id(p)] for pg in opt.param_groups for p in pg["params"]]
        if set(names) != set(mu):
            raise ValueError(f"group {group}: moments for {sorted(mu)}, parameters {sorted(names)}")
        template["state"] = {i: {"step": torch.tensor(float(count)), "exp_avg": mu[n], "exp_avg_sq": nu[n]}
                             for i, n in enumerate(names)} if count else {}
        groups[group] = template
    if len(counts) != 1:
        raise ValueError(f"the groups' Adam counts differ: {sorted(counts)}")
    from nerfstudio_torch.engine.trainer import aux_state

    return {"step": step, "model": state_dict, "optimizer": {"count": counts.pop(), "optimizers": groups},
            "aux": aux_state(grid), "generator": None}


def dataparser_outputs_from_jax(outputs: Any):
    """The JAX dataparser's ``DataparserOutputs`` -> the port's, cameras
    (types and distortion too) on the CPU."""
    from nerfstudio_torch.cameras.cameras import Cameras
    from nerfstudio_torch.data.dataparsers.base_dataparser import DataparserOutputs
    from nerfstudio_torch.data.scene_box import SceneBox

    cams = outputs.cameras
    arr = lambda x: None if x is None else np.array(x, copy=True)  # noqa: E731
    n = arr(cams.camera_to_worlds).reshape(-1, 3, 4).shape[0]
    cameras = Cameras.create(
        arr(cams.camera_to_worlds).reshape(n, 3, 4), arr(cams.fx), arr(cams.fy), arr(cams.cx), arr(cams.cy),
        np.broadcast_to(arr(cams.width).reshape(-1), (n,)).copy(),
        np.broadcast_to(arr(cams.height).reshape(-1), (n,)).copy(),
        distortion_params=arr(cams.distortion_params),
        camera_type=1 if cams.camera_type is None else _tensor(arr(cams.camera_type).reshape(-1), torch.int32),
        device="cpu")
    metadata = {}
    for k in ("points3D_xyz", "points3D_rgb"):
        if outputs.metadata.get(k) is not None:
            metadata[k] = torch.from_numpy(np.array(outputs.metadata[k], copy=True))
    alpha = outputs.alpha_color
    return DataparserOutputs(
        image_filenames=list(outputs.image_filenames), cameras=cameras,
        alpha_color=None if alpha is None else _tensor(alpha),
        scene_box=SceneBox(aabb=_tensor(outputs.scene_box.aabb)),
        mask_filenames=None if outputs.mask_filenames is None else list(outputs.mask_filenames),
        metadata=metadata, dataparser_transform=np.asarray(outputs.dataparser_transform, dtype=np.float32),
        dataparser_scale=float(outputs.dataparser_scale))
