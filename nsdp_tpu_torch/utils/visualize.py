"""Error colormaps for test-time mesh export (the port's copy of
``jet_colormap`` and ``error_map_colors`` from ``nsdp_tpu/utils/visualize.py``;
reference ``utils/visualize.py:36-79``, consumed at
``utils/generation.py:60-62``)."""

import numpy as np


def jet_colormap(values: np.ndarray, vmin: float = None, vmax: float = None):
    """Map scalars to RGB in [0,1] with a jet-style colormap."""
    values = np.asarray(values, dtype=np.float64)
    vmin = values.min() if vmin is None else vmin
    vmax = values.max() if vmax is None else vmax
    t = np.zeros_like(values) if vmax <= vmin else (values - vmin) / (vmax - vmin)
    t = np.clip(t, 0.0, 1.0)

    r = np.clip(1.5 - np.abs(4 * t - 3), 0, 1)
    g = np.clip(1.5 - np.abs(4 * t - 2), 0, 1)
    b = np.clip(1.5 - np.abs(4 * t - 1), 0, 1)
    return np.stack([r, g, b], axis=-1)


def error_map_colors(errors: np.ndarray, error_max: float = 0.1) -> np.ndarray:
    """Per-vertex uint8 colors for an error field (clamped at ``error_max``)."""
    rgb = jet_colormap(np.clip(errors, 0.0, error_max), 0.0, error_max)
    return (rgb * 255).astype(np.uint8)
