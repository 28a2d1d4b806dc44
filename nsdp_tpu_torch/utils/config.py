"""YAML config loading and validation.

The port's own copy of ``nsdp_tpu.utils.config``: the same YAML shape as the
reference (``utils/training_utils.py:14-31``), the same defaults, the same
checks, so the shipped config files (``configs/``) load unchanged.
"""

import json
import os
from typing import Any, Dict

import yaml

try:
    from yaml import CLoader as _Loader
except ImportError:  # pragma: no cover
    from yaml import Loader as _Loader


_DATA_DEFAULTS = {
    "interval": 1,
    "arbitrary": False,
    "inverse": False,
    "fix_coord_system": False,
    "num_surf_samples": 5000,
    "num_space_samples": 5000,
    "partial_range": 0.1,
    "noise_level": 0.0,
    "partial_shape_ratio": 1.0,
    "pad_partial_shapes": False,
    "norm_params_file": "orig_to_gaps.txt",
    "surface_flow_file": "surface_points.npz",
    "space_flow_file": "flow.npz",
    "mesh_file": "mesh_orig.obj",
}


def load_config(path: str) -> Dict[str, Any]:
    with open(path, "r") as f:
        config = yaml.load(f, Loader=_Loader)
    validate_config(config)
    return config


def validate_config(config: Dict[str, Any]) -> None:
    """Fill defaults and sanity-check required sections."""
    for section in ("experiment", "data", "model"):
        if section not in config:
            raise ValueError(f"config missing required section {section!r}")
    for key, default in _DATA_DEFAULTS.items():
        config["data"].setdefault(key, default)
    model = config["model"]
    for key in ("type", "encoder", "encoder_kwargs", "decoder", "decoder_kwargs"):
        if key not in model:
            raise ValueError(f"config.model missing {key!r}")
    if model["type"] not in ("forward", "backward", "arbitrary"):
        raise ValueError(f"unknown model type {model['type']!r}")
    model.setdefault("use_normals", False)


def save_experiment_params(args, experiment_name: str, directory: str, config=None) -> None:
    """Dump the argparse vars and the experiment config to ``params.json``
    (``nsdp_tpu/utils/config.py:64-75``; the reference
    ``utils/training_utils.py:19-31`` merges both)."""
    params = {k: str(v) for k, v in vars(args).items()}
    params["experiment_name"] = experiment_name
    if config is not None:
        params["config"] = config
    os.makedirs(directory, exist_ok=True)
    with open(os.path.join(directory, "params.json"), "w") as f:
        json.dump(params, f, indent=2)
