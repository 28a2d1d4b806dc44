"""Point-cloud ops: gathers, kNN, furthest-point sampling, fused kNN attention,
radius and 3-NN neighbourhoods.

``furthest_point_sample``, ``knn.knn``, ``gather_rows`` and
``fused_vector_attention`` (with its backward,
``attention.fused_vector_attention_backward``) are kernel wrappers: a CPU
tensor runs the plain PyTorch version, a CUDA tensor launches the
hand-written kernel (or raises).  ``nsdp_tpu_torch.ops.knn`` stays the
module (the wrapper is ``nsdp_tpu_torch.ops.knn.knn``).
"""

from nsdp_tpu_torch.ops.attention import fused_vector_attention
from nsdp_tpu_torch.ops.fps import furthest_point_sample
from nsdp_tpu_torch.ops.gather import (
    gather_operation,
    gather_rows,
    grouping_operation,
    index_points,
)
from nsdp_tpu_torch.ops.geometry import (
    ball_query,
    fibonacci_sphere,
    interpolation_weights,
    three_interpolate,
    three_nn,
)
from nsdp_tpu_torch.ops.knn import square_distance

__all__ = [
    "ball_query",
    "fibonacci_sphere",
    "furthest_point_sample",
    "fused_vector_attention",
    "gather_operation",
    "gather_rows",
    "grouping_operation",
    "index_points",
    "interpolation_weights",
    "square_distance",
    "three_interpolate",
    "three_nn",
]
