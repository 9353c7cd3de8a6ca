"""Vision Transformer (ViT-B/16, ViT-S/16) as an NCHW ``nn.Module``.

Counterpart of ``nbdt_tpu/models/vit.py``: patch embed, [CLS] token,
learned positions, pre-norm MHSA/MLP blocks, final LayerNorm and a linear
head. Parameter names are torchvision's ``VisionTransformer`` ones
(``conv_proj``, ``class_token``, ``encoder.pos_embedding``,
``encoder.layers.encoder_layer_{i}.{ln_1,self_attention,ln_2,mlp.0,mlp.3}``,
``encoder.ln``, ``heads.head``), the set that the JAX package's
``flax_to_torch_state_dict(..., "vit_b16")`` emits, so its output loads
with ``strict=True``.

The numerics follow flax, not torchvision: GELU is the tanh approximation,
LayerNorm's eps is 1e-6, the patch conv pads SAME (``pos_embed`` is sized
from ``image_size`` at construction), tokens flatten in NHWC row order, and
the query is scaled by ``1/sqrt(head_dim)`` before the product.

``dtype`` is the stream dtype: the patch conv, attention and MLP hold and
compute in it; LayerNorm parameters, the [CLS] token, the positions and the
classifier stay f32 (flax's param dtype), and ``features_only`` returns the
[CLS] row in f32. Knobs, as in the JAX package (numerics only; every variant
has the same parameters):

- ``ln_impl``: "f32" (LayerNorm in f32, f32 output that the next op casts),
  "bf16" (stats in f32, output in the stream dtype), or "pallas" (the
  hand-written kernel of :mod:`nbdt_torch.ops.layernorm`, output in the
  input dtype; forward only, so call it under ``torch.no_grad()``).
- ``attention_impl``: "flax" (explicit ``q @ k^T``, softmax and ``@ v`` in
  the stream dtype) or "jax" (``F.scaled_dot_product_attention``).
"""

from __future__ import annotations

import math
from collections import OrderedDict
from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.layernorm import fused_layernorm

LN_IMPLS = ("f32", "bf16", "pallas")
ATTENTION_IMPLS = ("flax", "jax")
MLP_RATIO = 4


def _lecun_normal_(w: torch.Tensor, fan_in: int) -> None:
    """flax's default kernel init: truncated normal, variance 1/fan_in."""
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978  # stddev of N(0,1) cut at +-2
    nn.init.trunc_normal_(w, std=std, a=-2 * std, b=2 * std)


class LayerNorm(nn.Module):
    """LayerNorm over the last axis with f32 ``weight``/``bias``, eps 1e-6."""

    def __init__(self, dim: int, impl: str, stream_dtype: torch.dtype, eps: float = 1e-6):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))
        self.impl, self.stream_dtype, self.eps = impl, stream_dtype, eps

    def forward(self, x):
        if self.impl == "pallas":
            return fused_layernorm(x, self.weight, self.bias, self.eps)
        out = F.layer_norm(x.float(), self.weight.shape, self.weight, self.bias, self.eps)
        return out if self.impl == "f32" else out.to(self.stream_dtype)


class SelfAttention(nn.Module):
    """Multi-head self-attention with torchvision's packed projection names
    (``in_proj_weight [3D, D]`` rows q|k|v, each head-major)."""

    def __init__(self, dim: int, heads: int, impl: str, dtype: torch.dtype):
        super().__init__()
        self.heads, self.impl = heads, impl
        self.in_proj_weight = nn.Parameter(torch.empty(3 * dim, dim))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * dim))
        self.out_proj = nn.Linear(dim, dim)
        # flax divides q by sqrt(head_dim) rounded to the stream dtype
        self.q_div = torch.tensor(math.sqrt(dim // heads), device="cpu").to(dtype).item()

    def forward(self, x):
        B, T, D = x.shape
        qkv = F.linear(x.to(self.in_proj_weight.dtype), self.in_proj_weight, self.in_proj_bias)
        q, k, v = qkv.view(B, T, 3, self.heads, D // self.heads).permute(2, 0, 3, 1, 4)
        if self.impl == "jax":
            o = F.scaled_dot_product_attention(q, k, v)
        else:
            o = torch.softmax((q / self.q_div) @ k.transpose(-2, -1), dim=-1) @ v
        return self.out_proj(o.transpose(1, 2).reshape(B, T, D))


class EncoderBlock(nn.Module):
    """x + attn(ln_1(x)), then + mlp(ln_2(x)); mlp.0 -> tanh GELU -> mlp.3."""

    def __init__(self, dim: int, heads: int, dtype: torch.dtype, ln_impl: str,
                 attention_impl: str):
        super().__init__()
        self.dtype = dtype
        self.ln_1 = LayerNorm(dim, ln_impl, dtype)
        self.self_attention = SelfAttention(dim, heads, attention_impl, dtype)
        self.ln_2 = LayerNorm(dim, ln_impl, dtype)
        self.mlp = nn.Sequential(OrderedDict([  # torchvision's indices: 2 and 4 are dropouts
            ("0", nn.Linear(dim, dim * MLP_RATIO)),
            ("1", nn.GELU(approximate="tanh")),
            ("3", nn.Linear(dim * MLP_RATIO, dim)),
        ]))

    def forward(self, x):
        x = x + self.self_attention(self.ln_1(x))
        return x + self.mlp(self.ln_2(x).to(self.dtype))


class Encoder(nn.Module):
    def __init__(self, tokens: int, dim: int, depth: int, block_kw: dict):
        super().__init__()
        self.pos_embedding = nn.Parameter(torch.empty(1, tokens, dim))
        self.layers = nn.Sequential(OrderedDict(
            (f"encoder_layer_{i}", EncoderBlock(dim, **block_kw)) for i in range(depth)))
        self.ln = LayerNorm(dim, block_kw["ln_impl"], block_kw["dtype"])


class ViT(nn.Module):
    """ViT over square NCHW images of ``image_size``; classifier ``heads.head``."""

    def __init__(self, patch: int = 16, dim: int = 768, depth: int = 12, heads: int = 12,
                 num_classes: int = 1000, dtype: torch.dtype = torch.float32,
                 ln_impl: str = "f32", attention_impl: str = "flax", image_size: int = 224):
        super().__init__()
        if ln_impl not in LN_IMPLS:
            raise ValueError(f"ln_impl must be one of {LN_IMPLS}, not {ln_impl!r}")
        if attention_impl not in ATTENTION_IMPLS:
            raise ValueError(f"attention_impl must be one of {ATTENTION_IMPLS}, "
                             f"not {attention_impl!r}")
        self.patch, self.dim, self.depth, self.num_heads = patch, dim, depth, heads
        self.num_classes, self.dtype, self.image_size = num_classes, dtype, image_size
        self.ln_impl, self.attention_impl = ln_impl, attention_impl
        self.grid = -(-image_size // patch)  # patches a side; SAME padding: ceil

        self.conv_proj = nn.Conv2d(3, dim, patch, patch)
        self.class_token = nn.Parameter(torch.zeros(1, 1, dim))
        self.encoder = Encoder(
            self.grid ** 2 + 1, dim, depth,
            dict(heads=heads, dtype=dtype, ln_impl=ln_impl, attention_impl=attention_impl))
        self.heads = nn.Sequential(OrderedDict(head=nn.Linear(dim, num_classes)))

        # flax's initializers
        nn.init.normal_(self.encoder.pos_embedding, std=0.02)
        for m in self.modules():
            if isinstance(m, (nn.Linear, nn.Conv2d)):
                _lecun_normal_(m.weight, m.weight[0].numel())
                nn.init.zeros_(m.bias)
            elif isinstance(m, SelfAttention):
                _lecun_normal_(m.in_proj_weight, dim)
        self.conv_proj.to(dtype)
        for block in self.encoder.layers:
            block.self_attention.to(dtype)
            block.mlp.to(dtype)

    def forward(self, x, features_only: bool = False):
        if tuple(x.shape[2:]) != (self.image_size, self.image_size):
            raise ValueError(f"ViT built for {self.image_size}px images, got {tuple(x.shape[2:])}")
        x = x.to(self.dtype)
        pad = self.grid * self.patch - self.image_size  # flax's SAME: the odd pixel after
        if pad:
            x = F.pad(x, [pad // 2, pad - pad // 2] * 2)
        h = self.conv_proj(x)
        B = h.shape[0]
        h = h.flatten(2).transpose(1, 2)  # [B, h*w, D], the NHWC reshape order
        cls = self.class_token.to(self.dtype).expand(B, -1, -1)
        h = torch.cat([cls, h], dim=1) + self.encoder.pos_embedding.to(self.dtype)
        h = self.encoder.ln(self.encoder.layers(h))
        feats = h[:, 0].float().contiguous()  # the fused head takes contiguous rows
        if features_only:
            return feats
        return self.heads.head(feats)

    def clone(self, dtype: Optional[torch.dtype] = None, ln_impl: Optional[str] = None,
              attention_impl: Optional[str] = None) -> "ViT":
        """A fresh module of the same architecture with other knobs; the
        caller loads its weights."""
        return ViT(self.patch, self.dim, self.depth, self.num_heads, self.num_classes,
                   dtype=self.dtype if dtype is None else dtype,
                   ln_impl=ln_impl or self.ln_impl,
                   attention_impl=attention_impl or self.attention_impl,
                   image_size=self.image_size)


def vit_b16(num_classes: int = 1000, dtype=torch.float32, **kwargs) -> ViT:
    return ViT(dim=768, depth=12, heads=12, num_classes=num_classes, dtype=dtype, **kwargs)


def vit_s16(num_classes: int = 1000, dtype=torch.float32, **kwargs) -> ViT:
    return ViT(dim=384, depth=12, heads=6, num_classes=num_classes, dtype=dtype, **kwargs)
