"""Weight carry-over from the JAX package's variables to the port's modules.

``from_jax_variables(params, batch_stats)`` takes the JAX model's variables
as plain nested dicts of numpy arrays and returns the port's ``state_dict``.
It inverts the torch -> flax key rules of the JAX package's checkpoint
converter (``nsdp_tpu/utils/torch_convert.py:9-19``), kept here as the
port's own copy:

* ModuleList entries ``transition_downs_0`` <- ``transition_downs.0``;
* two-layer Sequential MLPs ``fc_delta/fc0``, ``fc1`` <- ``fc_delta.0``, ``.2``;
* BatchNorms lose the wrapper level ``bn`` (``bn1/bn`` <- ``bn1``);
  ``scale``/``bias`` <- ``weight``/``bias``, ``mean``/``var`` <-
  ``running_mean``/``running_var``, plus ``num_batches_tracked`` = 0;
  flax's own BatchNorm (no wrapper level: the shared MLPs of
  ``ops/pointnet2_compat.py``, ``mlp0/bn0``) maps the same leaves;
* Dense ``kernel`` (in, out) <- Linear ``weight`` (out, in), transposed.

The PointNet++ encoder and the interpolation decoder need no rule of their
own: ``fc_begin`` is a two-layer MLP, ``transition_downs_0/sa/{fc1, conv1,
conv2}`` and the decoder's ``fc0``/``fc1`` are Dense layers outside a
Sequential, ``sa/{bn1, bn2, bn}`` wrapped BatchNorms.
"""

import re
from collections.abc import Mapping
from typing import Dict, Iterator, Tuple

import numpy as np
import torch

_MODULE_LISTS = {
    "transition_downs",
    "transformer_downs",
    "elementwise",
    "elementwise_extras",
    "final_transformers",
    "final_elementwise",
    "blocks",
    "fc_c",
}
_SEQ_MLPS = {
    "fc_delta",
    "fc_delta1",
    "fc_gamma",
    "fc_gamma1",
    "fc_gamma2",
    "fc_middle",
    "fc_begin",
}
_SEQ_INDEX = {"fc0": "0", "fc1": "2"}
_BN_NAMES = {"bn", "bn1", "bn2", "bn3", "bnorm0", "bnorm1", "bnorm2"}
_BN_LEAVES = {"scale": "weight", "bias": "bias", "mean": "running_mean",
              "var": "running_var"}


def _leaves(tree, prefix=()) -> Iterator[Tuple[tuple, np.ndarray]]:
    for key, value in tree.items():
        if isinstance(value, Mapping):
            yield from _leaves(value, prefix + (key,))
        else:
            yield prefix + (key,), np.asarray(value)


def _module_name(tokens) -> str:
    out = []
    for i, tok in enumerate(tokens):
        m = re.fullmatch(r"(.+)_(\d+)", tok)
        if m and m.group(1) in _MODULE_LISTS:
            out += [m.group(1), m.group(2)]
        elif tok in _SEQ_INDEX and i > 0 and tokens[i - 1] in _SEQ_MLPS:
            out.append(_SEQ_INDEX[tok])
        else:
            out.append(tok)
    return ".".join(out)


def from_jax_variables(params, batch_stats) -> Dict[str, torch.Tensor]:
    """JAX ``params``/``batch_stats`` trees -> the port's ``state_dict``
    (float32 CPU tensors; load with ``strict=True``)."""
    state: Dict[str, torch.Tensor] = {}
    for path, value in list(_leaves(params)) + list(_leaves(batch_stats)):
        *mods, leaf = path
        wrapped = len(mods) >= 2 and mods[-1] == "bn" and mods[-2] in _BN_NAMES
        if wrapped or leaf in ("scale", "mean", "var"):
            name = _module_name(mods[:-1] if wrapped else mods)
            state[f"{name}.{_BN_LEAVES[leaf]}"] = torch.tensor(value, dtype=torch.float32)
            state[f"{name}.num_batches_tracked"] = torch.tensor(0, dtype=torch.long)
        elif leaf == "kernel":
            state[f"{_module_name(mods)}.weight"] = torch.tensor(
                np.ascontiguousarray(value.T), dtype=torch.float32
            )
        elif leaf == "bias":
            state[f"{_module_name(mods)}.bias"] = torch.tensor(value, dtype=torch.float32)
        else:
            raise ValueError(f"unexpected variable {'/'.join(path)}")
    return state
