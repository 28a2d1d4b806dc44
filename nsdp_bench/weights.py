"""Seeded weights of a configuration, made on the device in two draws.

The same ``state_dict`` goes to the program and to the reference.  The
distributions are those of the port's seeded weights
(``nsdp_tpu_torch.models.init_random``): linear weights
N(0, 1/fan_in), biases N(0, 0.1^2), BatchNorm scale 1 + N(0, 0.1^2) and
shift N(0, 0.1^2), running mean N(0, 0.1^2), running variance U(0.5, 1.5),
drawn in two calls (one normal draw of every float leaf together, one
uniform draw of the running variances) from one ``torch.Generator`` on the
device.  Then, as a trained model's running statistics match its
activations, each BatchNorm's are set to its batch statistics on one
seeded request (:func:`calibrated_state`): without that, the drawn
statistics leave activations growing layer by layer, and the canonical
pose collapses to a blob a few hundredths across, where FPS and kNN sit on
near-ties (``PERF.md``).  The published checkpoints are not in the
repository.
"""

from typing import Dict

import torch

from nsdp_bench.reference.model import Reference, parameter_spec
from nsdp_bench.traffic import generate

CALIBRATION = {"queries": 2048, "handle_share": 0.15, "max_shift": 0.3, "box_margin": 0.1}


def seeded_state(model_cfg: Dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """-> {name: float32 tensor on ``device``} (the BatchNorm counters
    int64 zeros) for ``seed``."""
    spec = parameter_spec(model_cfg)
    device = torch.device(device)
    gen = torch.Generator(device=device).manual_seed(seed % 2 ** 63)
    sizes = [torch.Size(shape).numel() for _, shape, kind in spec if kind != "count"]
    normal = torch.randn(sum(sizes), generator=gen, device=device)
    n_var = sum(torch.Size(shape).numel() for _, shape, kind in spec if kind == "running_var")
    uniform = torch.rand(n_var, generator=gen, device=device)
    state, at, at_var = {}, 0, 0
    for name, shape, kind in spec:
        if kind == "count":
            state[name] = torch.zeros((), dtype=torch.long, device=device)
            continue
        n = torch.Size(shape).numel()
        draw = normal[at:at + n].view(shape)
        at += n
        if kind == "weight":
            t = draw / shape[1] ** 0.5
        elif kind == "bn_weight":
            t = 1.0 + 0.1 * draw
        elif kind == "running_var":
            t = 0.5 + uniform[at_var:at_var + n].view(shape)
            at_var += n
        else:  # bias, bn_bias, running_mean
            t = 0.1 * draw
        state[name] = t.contiguous()
    return state


def calibrated_state(model_cfg: Dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """:func:`seeded_state` with every BatchNorm's running statistics set
    to its batch statistics (the variance Bessel corrected) on one seeded
    request: ``npoints_per_layer[0]`` surface samples, 2048 queries."""
    state = seeded_state(model_cfg, seed, device)
    traffic = dict(CALIBRATION, pool=1,
                   surface_points=model_cfg["encoder_kwargs"]["npoints_per_layer"][0])
    r = generate.requests(traffic, seed + 1)[0]
    ref = Reference(model_cfg, state).train()
    ref.calibrate = True
    t = lambda a: torch.as_tensor(a, device=device)[None]
    with torch.no_grad():
        ref.predict(t(r["points"]), t(r["inputs"]), twice=False)
    return state
