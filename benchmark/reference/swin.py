"""Plain Swin Transformer (Liu et al., arXiv:2103.14030, Table 1), as the
official repository (microsoft/Swin-Transformer, ``models/swin_transformer.py``)
writes it: NCHW images, f32, attention written out.

- Patch embedding: a ``patch_size`` conv at stride ``patch_size`` to
  ``embed_dim``, the tokens in row order, LayerNorm.
- Stage ``i``: width ``embed_dim * 2**i``, ``num_heads[i]`` heads,
  ``depths[i]`` blocks on a grid of side ``R``; window ``M = min(window_size,
  R)``; shift ``M // 2`` in odd blocks where ``R > window_size``, else 0.
- Block: ``x + W-MSA(LN1(x))``, then ``+ MLP(LN2(x))``: ``fc1``, exact (erf)
  GELU, ``fc2``, ``mlp_ratio`` wide.
- W-MSA: ``torch.roll`` by ``(-s, -s)``, the windows cut out, ``qkv`` with
  bias, ``q * head_dim ** -0.5``, scores ``q k^T``, plus
  ``relative_position_bias_table[relative_position_index]``, plus (where ``s
  > 0``) the mask of the official slices (-100 between regions), softmax,
  ``@ v``, ``proj``, the windows put back, ``torch.roll`` by ``(s, s)``.
- Patch merging after each stage but the last: ``x[0::2, 0::2]``,
  ``x[1::2, 0::2]``, ``x[0::2, 1::2]``, ``x[1::2, 1::2]`` concatenated,
  LayerNorm, ``reduction`` without bias.
- Head: LayerNorm, the mean over tokens, ``head``.

Departures from the official model: no dropout and no stochastic depth
(eval); the relative position index and the shift mask are computed in
each call from the shapes, where the official code keeps them as buffers
(``relative_position_index``, ``attn_mask``), so the state dict holds the
parameters alone; the evaluation transform (a resize to 384 and the
ImageNet normalisation) is left to the caller.

Parameter names are the official ones, so one state dict loads into this
module and into the program's. :func:`window_attention_work` counts the
windowed attention's operations and bytes from the shapes, for its
roofline; :func:`layernorm_shapes` lists the LayerNorms a forward runs, for
the LayerNorm kernel's.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F


def layer_norm(x, ln: nn.Module, eps: float):
    mean = x.mean(-1, keepdim=True)
    var = ((x - mean) ** 2).mean(-1, keepdim=True)
    return (x - mean) / torch.sqrt(var + eps) * ln.weight + ln.bias


class LN(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))


def window_partition(x, M: int):
    """``[B, H, W, C]`` -> ``[B * nW, M * M, C]``."""
    B, H, W, C = x.shape
    x = x.view(B, H // M, M, W // M, M, C).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(-1, M * M, C)


def window_reverse(windows, M: int, H: int, W: int):
    """``[B * nW, M * M, C]`` -> ``[B, H, W, C]``."""
    C = windows.shape[-1]
    x = windows.view(-1, H // M, W // M, M, M, C).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(-1, H, W, C)


def relative_position_index(M: int, device):
    coords = torch.stack(torch.meshgrid(torch.arange(M, device=device),
                                        torch.arange(M, device=device), indexing="ij"))
    coords = coords.flatten(1)  # [2, M*M]
    rel = (coords[:, :, None] - coords[:, None, :]).permute(1, 2, 0) + (M - 1)
    return rel[:, :, 0] * (2 * M - 1) + rel[:, :, 1]  # [M*M, M*M]


def shift_mask(R: int, M: int, s: int, device):
    """The official ``attn_mask``: ``[nW, M*M, M*M]``, -100 between tokens of
    different regions of the rolled grid, 0 within one."""
    img = torch.zeros(1, R, R, 1, device=device)
    cuts = (slice(0, -M), slice(-M, -s), slice(-s, None))
    n = 0
    for h in cuts:
        for w in cuts:
            img[:, h, w, :] = n
            n += 1
    windows = window_partition(img, M).squeeze(-1)  # [nW, M*M]
    mask = windows[:, None, :] - windows[:, :, None]
    return mask.masked_fill(mask != 0, -100.0).masked_fill(mask == 0, 0.0)


class WindowAttention(nn.Module):
    def __init__(self, dim: int, heads: int, M: int):
        super().__init__()
        self.heads, self.M = heads, M
        self.relative_position_bias_table = nn.Parameter(torch.zeros((2 * M - 1) ** 2, heads))
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)

    def forward(self, x, mask=None):
        Bw, N, C = x.shape
        hd = C // self.heads
        qkv = self.qkv(x).reshape(Bw, N, 3, self.heads, hd).permute(2, 0, 3, 1, 4)
        q, k, v = qkv[0], qkv[1], qkv[2]
        attn = (q * hd ** -0.5) @ k.transpose(-2, -1)
        index = relative_position_index(self.M, x.device)
        bias = self.relative_position_bias_table[index.view(-1)].view(N, N, -1)
        attn = attn + bias.permute(2, 0, 1).unsqueeze(0)
        if mask is not None:
            nW = mask.shape[0]
            attn = attn.view(Bw // nW, nW, self.heads, N, N) + mask.unsqueeze(1).unsqueeze(0)
            attn = attn.view(-1, self.heads, N, N)
        attn = torch.softmax(attn, dim=-1)
        return self.proj((attn @ v).transpose(1, 2).reshape(Bw, N, C))


class Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, dim)

    def forward(self, x):
        return self.fc2(F.gelu(self.fc1(x)))


class Block(nn.Module):
    def __init__(self, dim: int, heads: int, R: int, M: int, shift: int, mlp_ratio: int,
                 eps: float):
        super().__init__()
        self.R, self.M, self.shift, self.eps = R, M, shift, eps
        self.norm1 = LN(dim)
        self.attn = WindowAttention(dim, heads, M)
        self.norm2 = LN(dim)
        self.mlp = Mlp(dim, dim * mlp_ratio)

    def forward(self, x):
        B, L, C = x.shape
        R, M, s = self.R, self.M, self.shift
        h = layer_norm(x, self.norm1, self.eps).view(B, R, R, C)
        if s:
            h = torch.roll(h, shifts=(-s, -s), dims=(1, 2))
        mask = shift_mask(R, M, s, x.device) if s else None
        h = window_reverse(self.attn(window_partition(h, M), mask), M, R, R)
        if s:
            h = torch.roll(h, shifts=(s, s), dims=(1, 2))
        x = x + h.reshape(B, L, C)
        return x + self.mlp(layer_norm(x, self.norm2, self.eps))


class PatchMerging(nn.Module):
    def __init__(self, dim: int, eps: float):
        super().__init__()
        self.eps = eps
        self.reduction = nn.Linear(4 * dim, 2 * dim, bias=False)
        self.norm = LN(4 * dim)

    def forward(self, x, R: int):
        B, L, C = x.shape
        x = x.view(B, R, R, C)
        x = torch.cat([x[:, 0::2, 0::2], x[:, 1::2, 0::2], x[:, 0::2, 1::2], x[:, 1::2, 1::2]], -1)
        return self.reduction(layer_norm(x.view(B, -1, 4 * C), self.norm, self.eps))


class BasicLayer(nn.Module):
    def __init__(self, dim: int, depth: int, heads: int, R: int, window: int, mlp_ratio: int,
                 merge: bool, eps: float):
        super().__init__()
        self.R = R
        M = min(window, R)
        shift = M // 2 if R > window else 0
        self.blocks = nn.ModuleList(Block(dim, heads, R, M, shift if j % 2 else 0, mlp_ratio, eps)
                                    for j in range(depth))
        self.downsample = PatchMerging(dim, eps) if merge else None

    def forward(self, x):
        for block in self.blocks:
            x = block(x)
        return x if self.downsample is None else self.downsample(x, self.R)


class PatchEmbed(nn.Module):
    def __init__(self, patch: int, dim: int):
        super().__init__()
        self.proj = nn.Conv2d(3, dim, patch, patch)
        self.norm = LN(dim)


class Swin(nn.Module):
    """``features(x)``: the mean of the final tokens ``[B, num_features]`` of
    NCHW images; ``forward(x)``: the logits."""

    # parameters drawn N(0, std^2) in a seeded init, by the end of their name
    normal_std = {"relative_position_bias_table": 0.02}

    def __init__(self, image_size: int, patch_size: int, embed_dim: int, depths, num_heads,
                 window_size: int, mlp_ratio: int, num_classes: int, eps: float):
        super().__init__()
        self.eps = eps
        self.patch_embed = PatchEmbed(patch_size, embed_dim)
        R = image_size // patch_size
        self.layers = nn.ModuleList()
        for i, (depth, heads) in enumerate(zip(depths, num_heads)):
            merge = i < len(depths) - 1
            self.layers.append(BasicLayer(embed_dim * 2 ** i, depth, heads, R, window_size,
                                          mlp_ratio, merge, eps))
            R = R // 2 if merge else R
        features = embed_dim * 2 ** (len(depths) - 1)
        self.norm = LN(features)
        self.head = nn.Linear(features, num_classes)

    @classmethod
    def from_sizes(cls, sizes: dict) -> "Swin":
        """The model of a configuration's ``model`` sizes."""
        return cls(sizes["image_size"], sizes["patch_size"], sizes["embed_dim"], sizes["depths"],
                   sizes["num_heads"], sizes["window_size"], sizes["mlp_ratio"],
                   sizes["num_classes"], sizes["layer_norm_eps"])

    @property
    def classifier(self) -> nn.Linear:
        return self.head

    def blocks(self) -> list:
        """The blocks in order."""
        return [b for layer in self.layers for b in layer.blocks]

    def features(self, x: torch.Tensor) -> torch.Tensor:
        h = self.patch_embed.proj(x).flatten(2).transpose(1, 2)
        h = layer_norm(h, self.patch_embed.norm, self.eps)
        for layer in self.layers:
            h = layer(h)
        return layer_norm(h, self.norm, self.eps).mean(1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.head(self.features(x))


def window_attention_work(sizes: dict, batch: int) -> list:
    """Each block's windowed attention (``LN1``, W-MSA and the residual add)
    on ``batch`` images of a configuration's ``model`` sizes, from the
    shapes, one ``{"flops", "bytes"}`` a block in order: the products of
    ``qkv``, the scores, the values and ``proj`` at 2 operations a
    multiply-add; in f32 the block's input read once, its output written
    once, and its ``qkv`` and ``proj`` weights and biases and its bias table
    read once."""
    with torch.device("meta"):
        model = Swin.from_sizes(sizes)
    out = []
    for block in model.blocks():
        C, N = block.norm1.weight.numel(), block.M ** 2
        tokens = batch * block.R ** 2
        flops = 2 * tokens * (3 * C * C + 2 * N * C + C * C)
        weights = sum(p.numel() for p in block.attn.parameters())
        out.append({"flops": flops, "bytes": 4 * (2 * tokens * C + weights)})
    return out


def layernorm_shapes(sizes: dict, batch: int) -> list:
    """Each LayerNorm of a forward of ``batch`` images of a configuration's
    ``model`` sizes, in order, as ``(rows, width)``: the patch embedding's,
    each block's two, each merge's over ``4C`` at the halved grid, and the
    final one."""
    with torch.device("meta"):
        model = Swin.from_sizes(sizes)
    R = sizes["image_size"] // sizes["patch_size"]
    out = [(batch * R * R, model.patch_embed.norm.weight.numel())]
    for layer in model.layers:
        for block in layer.blocks:
            out += [(batch * block.R ** 2, block.norm1.weight.numel())] * 2
        if layer.downsample is not None:
            out.append((batch * (layer.R // 2) ** 2, layer.downsample.norm.weight.numel()))
    return out + [(batch * model.layers[-1].R ** 2, model.norm.weight.numel())]
