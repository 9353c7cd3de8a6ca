"""Hand-written CUDA kernels of the port, each beside its plain version."""

from .soft_traversal import (
    fused_soft_head,
    make_fused_soft_head,
    prepare_head_constants,
    soft_head_reference,
)
