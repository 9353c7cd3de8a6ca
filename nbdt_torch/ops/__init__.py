"""Hand-written CUDA kernels of the port, each beside its plain version."""

from .conv3x3 import conv3x3_bias_relu, conv3x3_bias_relu_reference
from .layernorm import fused_layernorm, layernorm_reference
from .soft_traversal import (
    fused_soft_head,
    make_fused_soft_head,
    prepare_head_constants,
    soft_head_reference,
)
