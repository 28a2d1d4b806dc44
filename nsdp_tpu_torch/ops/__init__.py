"""Point-cloud ops: gathers, furthest-point sampling, fused kNN attention.

``furthest_point_sample`` and ``fused_vector_attention`` (with its
backward, ``attention.fused_vector_attention_backward``) are kernel
wrappers: a CPU tensor runs the plain PyTorch version, a CUDA tensor
launches the hand-written kernel (or raises).
"""

from nsdp_tpu_torch.ops.attention import fused_vector_attention
from nsdp_tpu_torch.ops.fps import furthest_point_sample
from nsdp_tpu_torch.ops.gather import index_points

__all__ = ["fused_vector_attention", "furthest_point_sample", "index_points"]
