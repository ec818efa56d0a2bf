"""Load the JAX package's parameters and occupancy grids into the port.

Takes nested dicts of numpy arrays (``jax.device_get`` of a flax params
tree or a ``TrainState`` works as is) and imports no jax. Dense kernels
``(in, out)`` become ``weight (out, in)`` (the SDF field's weight-normed
kernels too, beside their ``scale``); hash tables keep their ``(L, S,
128)`` layout, block and flat alike; list members such as ``layers_0``,
``glin_0`` or ``proposal_networks_1`` become ``layers.0``, ``glin.0``,
``proposal_networks.1``; ``LearnedVariance``'s scalar stays a scalar. Every leaf must land on exactly one parameter: anything left
over on either side raises. ``splat_state_from_jax`` carries a splatfacto
train state whole: gaussians, densification state and Adam moments."""

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
        parts += [match[1], match[2]] if match else [m]
    if leaf == "kernel":
        return ".".join(parts + ["weight"]), True
    if leaf in ("bias", "hash_table", "pose_adjustment"):
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
    if isinstance(obj, Mapping):
        return dict(obj)
    return {f.name: getattr(obj, f.name) for f in dataclasses.fields(obj)}


def _tensor(x: Any, dtype=torch.float32) -> torch.Tensor:
    return torch.from_numpy(np.array(x, copy=True)).to(dtype)


def splat_state_from_jax(state: Any):
    """The JAX ``SplatTrainState`` (numpy leaves, e.g. ``jax.device_get`` of
    it) -> (params, ``SplatAux``, Adam moments, step) of the port, for
    ``SplatPipeline.state_from``. The moments are {array: (count, mu, nu)},
    read from the per-array optax Adams of ``build_splat_optimizers``; the
    ``means`` schedule's count must equal its Adam's."""
    from nerfstudio_torch.models.splatfacto import GAUSSIAN_ARRAYS, SplatAux

    fields = _fields(state)
    params = {k: _tensor(v) for k, v in _fields(fields["params"]).items()}
    if set(params) != set(GAUSSIAN_ARRAYS):
        raise ValueError(f"splat params {sorted(params)}: the port has exactly {sorted(GAUSSIAN_ARRAYS)}")
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
