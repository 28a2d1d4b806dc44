"""Load a stage-1 network into one branch of the 'arbitrary' model
(counterpart of ``nsdp_tpu/training/partial_load.py``; reference
``model/__init__.py:82-104``)."""

import warnings

from torch import nn

from nsdp_tpu_torch.training.checkpoints import read_state_dict


def load_subnetwork(model: nn.Module, path: str, subtree: str) -> nn.Module:
    """Load the ``DeformationNetwork`` checkpoint at ``path`` (the port's
    ``model_*`` files or a reference torch file) into ``model.<subtree>``,
    ``subtree`` being 'model_deform' or 'model_canonicalize'.

    A key the branch needs and the file lacks is an error; a key the file has
    and the branch does not (the published files carry the unused q/k/v
    projections of a pos-only first block) is dropped with a warning.
    """
    if subtree not in ("model_deform", "model_canonicalize") or not hasattr(model, subtree):
        raise KeyError(f"{subtree!r} is not a branch of an 'arbitrary' model")
    branch = getattr(model, subtree)
    missing, unexpected = branch.load_state_dict(read_state_dict(path), strict=False)
    if missing:
        raise ValueError(f"{path} lacks {len(missing)} keys of {subtree}, e.g. {missing[:3]}")
    if unexpected:
        warnings.warn(f"{path}: dropping {len(unexpected)} keys {subtree} does not use, "
                      f"e.g. {unexpected[:3]}")
    return model
