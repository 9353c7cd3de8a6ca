"""Swin Transformer (Liu et al., arXiv:2103.14030) as an NCHW ``nn.Module``.

``swin_b_w12_384`` is Swin-B at 384px with window 12, the official
repository's ``swin_base_patch4_window12_384`` (microsoft/Swin-Transformer):
embed dim 128, depths 2/2/18/2, heads 4/8/16/32 (head dim 32), patch 4.
The JAX package has no counterpart. The equations are the official ones:

- Patch embedding: a ``patch`` x ``patch`` conv at stride ``patch`` to
  ``embed_dim``, the tokens in row order, LayerNorm.
- Stage ``i``: width ``embed_dim * 2**i``, ``heads[i]`` heads and
  ``depths[i]`` blocks on a grid of side ``R``. Its window is ``M =
  min(window, R)``; a block's shift ``s`` is ``M // 2`` in odd blocks and 0
  in even ones, and 0 wherever ``R <= window``.
- Block: ``x + W-MSA(LN1(x))``, then ``+ MLP(LN2(x))`` (``fc1``, exact erf
  GELU, ``fc2``; ratio 4). LayerNorm's eps is 1e-5.
- W-MSA: the grid rolled by ``(-s, -s)`` and cut into ``M x M`` windows;
  ``qkv`` (with bias), q scaled by ``head_dim ** -0.5``; scores ``q k^T``
  plus the relative position bias ``table[index]`` (a ``[(2M-1)^2, heads]``
  table) and, where ``s > 0``, the shift mask (-100 between tokens of
  different regions of the rolled grid); softmax over the keys; times
  ``v``; ``proj``; the windows put back and the grid rolled by ``(s, s)``.
- Patch merging after every stage but the last: the neighbours
  ``x[0::2, 0::2]``, ``x[1::2, 0::2]``, ``x[0::2, 1::2]``, ``x[1::2, 1::2]``
  concatenated, LayerNorm, ``reduction`` (no bias) to twice the width.
- Head: LayerNorm, the mean over tokens (``features_only`` returns that
  ``[B, num_features]`` f32 row, contiguous), ``head``.

How it computes them: the roll and the window cut are one gather of the
tokens by a precomputed order, and putting the windows back is one gather
by the inverse order (``torch.roll`` over two axes and the cut's permute
are three copies each way); the shift mask joins the bias before the one
add to the scores. Each stage builds its blocks' token orders, the
relative-position index and the shift mask from shapes on the input's
device at first use and keeps them outside the state dict: the official
``relative_position_index`` and ``attn_mask`` buffers are not kept, so a
model built on the meta device takes a state dict with ``assign=True`` and
runs, and the state dict holds floats only.

Parameter names are the official ones (``patch_embed.proj``,
``patch_embed.norm``, ``layers.{i}.blocks.{j}.{norm1, attn.qkv,
attn.proj, attn.relative_position_bias_table, norm2, mlp.fc1, mlp.fc2}``,
``layers.{i}.downsample.{norm, reduction}``, ``norm``, ``head``), so an
official checkpoint's ``model`` entry loads once those two buffers are
dropped. The init is the official one: linear weights and the bias tables
truncated N(0, 0.02^2), linear biases 0, LayerNorms 1 and 0.

Inside the NBDT wrapper's ``backbone`` span each block runs its two halves
in spans (recorded only under a profiler), each with the attributes
``stage``, ``shifted`` and ``windows`` (the ``B * nW`` windows it attends):

    backbone
      window_attention   LN1, the gather into windows, W-MSA, the gather
                         back, the residual add
      mlp                LN2, fc1, GELU, fc2, the residual add

The patch embedding, the merges, the final LayerNorm and the mean run in
``backbone`` outside them. At Swin-B/384 that is 24 of each a call, 11
``window_attention`` spans shifted. ``swin_b_w12_384`` is the benchmark's
``swin_b_w12_384_imagenet1000`` configuration.

``dtype`` is the stream dtype and ``ln_impl`` the LayerNorm, as in
``models/vit.py``: the patch conv and every linear layer but the head hold
and compute in ``dtype``; LayerNorm parameters, the bias tables (cast at
use) and the head stay f32. ``ln_impl="pallas"`` is the hand-written
kernel of :mod:`nbdt_torch.ops.layernorm` (forward only; every width here
is a multiple of 128, as it requires).
"""

from __future__ import annotations

import itertools

import torch
import torch.nn as nn

from ..profiling import span
from .vit import LN_IMPLS, LayerNorm

EPS = 1e-5
MLP_RATIO = 4
MASKED = -100.0  # the shift mask's score between tokens of different regions


def partition(grid: torch.Tensor, window: int) -> torch.Tensor:
    """The entries of a square ``[R, R]`` grid in window order: window by
    window in row order, each window's ``window ** 2`` entries in row
    order."""
    R = grid.shape[0]
    return grid.view(R // window, window, R // window, window).transpose(1, 2).reshape(-1)


def window_geometry(side: int, window: int, shift: int, device) -> tuple:
    """``(order, inverse, index, mask)`` of a block on a ``side`` x ``side``
    grid: ``order[k]``, the token (row-major on the grid) at place ``k`` of
    the rolled grid's windows, and its inverse; the ``[N * N]``
    relative-position index into the bias table (``N = window ** 2``); the
    ``[nW, N, N]`` shift mask, or None where ``shift`` is 0."""
    grid = torch.arange(side * side, device=device).view(side, side)
    order = partition(grid.roll((-shift, -shift), (0, 1)) if shift else grid, window)
    inverse = torch.empty_like(order)
    inverse[order] = torch.arange(side * side, device=device)
    at = torch.arange(window, device=device)  # a window's tokens' rows and columns
    rows, cols = (t[:, None] - t[None, :] + window - 1
                  for t in (at.repeat_interleave(window), at.repeat(window)))
    index = (rows * (2 * window - 1) + cols).reshape(-1)
    if not shift:
        return order, inverse, index, None
    region = torch.zeros(side, side, device=device)
    cuts = (slice(0, -window), slice(-window, -shift), slice(-shift, None))
    for n, (h, w) in enumerate(itertools.product(cuts, cuts)):
        region[h, w] = n
    windows = partition(region, window).view(-1, window ** 2)
    apart = windows[:, None, :] != windows[:, :, None]
    return order, inverse, index, torch.zeros(apart.shape, device=device).masked_fill_(apart, MASKED)


class WindowAttention(nn.Module):
    """Multi-head self-attention within windows, with the relative position
    bias: ``[windows, N, C]`` -> ``[windows, N, C]``."""

    def __init__(self, dim: int, heads: int, window: int):
        super().__init__()
        self.heads, self.scale = heads, (dim // heads) ** -0.5
        self.relative_position_bias_table = nn.Parameter(
            torch.zeros((2 * window - 1) ** 2, heads))
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)

    def forward(self, x, index, mask):
        W, N, C = x.shape
        q, k, v = self.qkv(x).view(W, N, 3, self.heads, C // self.heads).permute(2, 0, 3, 1, 4)
        scores = (q * self.scale) @ k.transpose(-2, -1)  # [W, heads, N, N]
        bias = self.relative_position_bias_table[index].view(N, N, -1).permute(2, 0, 1)
        if mask is not None:  # [nW, heads, N, N]; the windows of one image are consecutive
            bias = bias + mask[:, None]
        scores.view(-1, *bias.shape).add_(bias.to(scores.dtype))
        out = scores.softmax(-1) @ v
        return self.proj(out.transpose(1, 2).reshape(W, N, C))


class Mlp(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.fc1 = nn.Linear(dim, dim * MLP_RATIO)
        self.act = nn.GELU()
        self.fc2 = nn.Linear(dim * MLP_RATIO, dim)

    def forward(self, x):
        return self.fc2(self.act(self.fc1(x)))


class SwinBlock(nn.Module):
    """``x + W-MSA(LN1(x))``, then ``+ MLP(LN2(x))``, on ``[B, L, C]`` tokens
    in row order."""

    def __init__(self, dim: int, heads: int, window: int, shift: int, stage: int,
                 ln_impl: str, dtype: torch.dtype):
        super().__init__()
        self.window, self.shift, self.stage, self.dtype = window, shift, stage, dtype
        self.norm1 = LayerNorm(dim, ln_impl, dtype, EPS)
        self.attn = WindowAttention(dim, heads, window)
        self.norm2 = LayerNorm(dim, ln_impl, dtype, EPS)
        self.mlp = Mlp(dim)

    def forward(self, x, geometry):
        order, inverse, index, mask = geometry
        B, L, C = x.shape
        attrs = dict(stage=self.stage, shifted=bool(self.shift),
                     windows=B * L // self.window ** 2)
        with span("window_attention", x.device, **attrs):
            h = self.norm1(x).to(self.dtype).index_select(1, order)
            h = self.attn(h.view(-1, self.window ** 2, C), index, mask)
            x = x + h.view(B, L, C).index_select(1, inverse)
        with span("mlp", x.device, **attrs):
            return x + self.mlp(self.norm2(x).to(self.dtype))


class PatchMerging(nn.Module):
    """The 2x2 neighbours of a ``side`` x ``side`` grid of ``[B, L, C]``
    tokens concatenated (offsets (0, 0), (1, 0), (0, 1), (1, 1) in (row,
    column)), LayerNorm, a linear map to ``2C``."""

    def __init__(self, dim: int, ln_impl: str, dtype: torch.dtype):
        super().__init__()
        self.dtype = dtype
        self.reduction = nn.Linear(4 * dim, 2 * dim, bias=False)
        self.norm = LayerNorm(4 * dim, ln_impl, dtype, EPS)

    def forward(self, x, side: int):
        B, L, C = x.shape
        x = x.view(B, side // 2, 2, side // 2, 2, C).permute(0, 1, 3, 4, 2, 5)
        return self.reduction(self.norm(x.reshape(B, L // 4, 4 * C)).to(self.dtype))


class BasicLayer(nn.Module):
    """One stage: its blocks on a ``side`` x ``side`` grid, then the merge
    where it has one. Keeps its blocks' geometry (:func:`window_geometry`)
    by device and shift, outside the state dict."""

    def __init__(self, stage: int, dim: int, depth: int, heads: int, side: int, window: int,
                 merge: bool, ln_impl: str, dtype: torch.dtype):
        super().__init__()
        self.side, self.window = side, min(window, side)
        shift = self.window // 2 if side > window else 0
        self.blocks = nn.ModuleList(
            SwinBlock(dim, heads, self.window, shift if j % 2 else 0, stage, ln_impl, dtype)
            for j in range(depth))
        self.downsample = PatchMerging(dim, ln_impl, dtype) if merge else None
        self._geometry = {}

    def geometry(self, device, shift: int) -> tuple:
        key = (device, shift)
        if key not in self._geometry:
            self._geometry[key] = window_geometry(self.side, self.window, shift, device)
        return self._geometry[key]

    def forward(self, x):
        for block in self.blocks:
            x = block(x, self.geometry(x.device, block.shift))
        return x if self.downsample is None else self.downsample(x, self.side)


class PatchEmbed(nn.Module):
    def __init__(self, patch: int, dim: int, ln_impl: str, dtype: torch.dtype):
        super().__init__()
        self.proj = nn.Conv2d(3, dim, patch, patch)
        self.norm = LayerNorm(dim, ln_impl, dtype, EPS)


class SwinTransformer(nn.Module):
    """Swin over square NCHW images of ``image_size``; classifier ``head``."""

    def __init__(self, image_size: int = 384, patch: int = 4, embed_dim: int = 128,
                 depths=(2, 2, 18, 2), heads=(4, 8, 16, 32), window: int = 12,
                 num_classes: int = 1000, dtype: torch.dtype = torch.float32,
                 ln_impl: str = "f32"):
        super().__init__()
        if ln_impl not in LN_IMPLS:
            raise ValueError(f"ln_impl must be one of {LN_IMPLS}, not {ln_impl!r}")
        if image_size % patch or len(depths) != len(heads):
            raise ValueError(f"Swin takes images a whole number of {patch}px patches wide and "
                             f"one head count a stage, not {image_size}px and {depths}, {heads}")
        self.image_size, self.dtype = image_size, dtype
        self.num_features = embed_dim * 2 ** (len(depths) - 1)

        self.patch_embed = PatchEmbed(patch, embed_dim, ln_impl, dtype)
        self.layers = nn.ModuleList()
        side = image_size // patch
        for i, (depth, h) in enumerate(zip(depths, heads)):
            merge = i < len(depths) - 1
            if (side > window and side % window) or (merge and side % 2):
                raise ValueError(f"stage {i}'s grid of {side} does not split into windows of "
                                 f"{window} or merge by 2: {image_size}px does not fit")
            self.layers.append(BasicLayer(i, embed_dim * 2 ** i, depth, h, side, window, merge,
                                          ln_impl, dtype))
            side //= 2 if merge else 1
        self.norm = LayerNorm(self.num_features, ln_impl, dtype, EPS)
        self.head = nn.Linear(self.num_features, num_classes)

        for m in self.modules():  # the official init
            if isinstance(m, nn.Linear):
                nn.init.trunc_normal_(m.weight, std=0.02)
                if m.bias is not None:
                    nn.init.zeros_(m.bias)
            elif isinstance(m, WindowAttention):
                nn.init.trunc_normal_(m.relative_position_bias_table, std=0.02)
        self.patch_embed.proj.to(dtype)
        for m in self.modules():
            if isinstance(m, nn.Linear) and m is not self.head:
                m.to(dtype)

    def forward(self, x, features_only: bool = False):
        if tuple(x.shape[2:]) != (self.image_size, self.image_size):
            raise ValueError(f"Swin built for {self.image_size}px images, got {tuple(x.shape[2:])}")
        h = self.patch_embed.proj(x.to(self.dtype)).flatten(2).transpose(1, 2)
        h = self.patch_embed.norm(h).to(self.dtype)
        for layer in self.layers:
            h = layer(h)
        feats = self.norm(h).mean(1).float().contiguous()  # the fused head takes contiguous rows
        if features_only:
            return feats
        return self.head(feats)


def swin_b_w12_384(num_classes: int = 1000, dtype=torch.float32, image_size: int = 384,
                   **kwargs) -> SwinTransformer:
    return SwinTransformer(image_size, 4, 128, (2, 2, 18, 2), (4, 8, 16, 32), 12, num_classes,
                           dtype, **kwargs)
