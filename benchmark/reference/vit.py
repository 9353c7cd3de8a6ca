"""Plain Vision Transformer (Dosovitskiy et al., arXiv:2010.11929, Table 1,
with the numerics of the authors' ``vit_jax`` release): a 16x16 patch
convolution, a class token and learned positions, pre-norm blocks of
multi-head self-attention and a two-layer MLP with tanh-approximated GELU,
LayerNorm with eps 1e-6, a final LayerNorm and a linear head on the class
token. Queries are scaled by ``1/sqrt(head_dim)`` before the product.
NCHW images, f32; attention is written out (scores, softmax, values).

Parameter names are torchvision's ``VisionTransformer`` ones, so one state
dict loads into this module and into the program's.
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F


def layer_norm(x, ln: nn.Module, eps: float = 1e-6):
    mean = x.mean(-1, keepdim=True)
    var = ((x - mean) ** 2).mean(-1, keepdim=True)
    return (x - mean) / torch.sqrt(var + eps) * ln.weight + ln.bias


class LN(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))


class Attention(nn.Module):
    def __init__(self, dim: int, heads: int):
        super().__init__()
        self.heads = heads
        self.in_proj_weight = nn.Parameter(torch.empty(3 * dim, dim))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * dim))
        self.out_proj = nn.Linear(dim, dim)

    def forward(self, x):
        B, T, D = x.shape
        hd = D // self.heads
        q, k, v = F.linear(x, self.in_proj_weight, self.in_proj_bias).split(D, dim=-1)
        q, k, v = (t.reshape(B, T, self.heads, hd).transpose(1, 2) for t in (q, k, v))
        scores = (q / math.sqrt(hd)) @ k.transpose(-2, -1)
        out = torch.softmax(scores, dim=-1) @ v
        return self.out_proj(out.transpose(1, 2).reshape(B, T, D))


class Block(nn.Module):
    def __init__(self, dim: int, heads: int, mlp: int):
        super().__init__()
        self.ln_1 = LN(dim)
        self.self_attention = Attention(dim, heads)
        self.ln_2 = LN(dim)
        self.mlp = nn.ModuleDict({"0": nn.Linear(dim, mlp), "3": nn.Linear(mlp, dim)})

    def forward(self, x):
        x = x + self.self_attention(layer_norm(x, self.ln_1))
        h = F.gelu(self.mlp["0"](layer_norm(x, self.ln_2)), approximate="tanh")
        return x + self.mlp["3"](h)


class Encoder(nn.Module):
    def __init__(self, tokens: int, dim: int, depth: int, heads: int, mlp: int):
        super().__init__()
        self.pos_embedding = nn.Parameter(torch.zeros(1, tokens, dim))
        self.layers = nn.ModuleDict(
            {f"encoder_layer_{i}": Block(dim, heads, mlp) for i in range(depth)})
        self.ln = LN(dim)


class ViT(nn.Module):
    # parameters drawn N(0, std^2) in a seeded init, by the end of their name
    normal_std = {"class_token": 0.02, "pos_embedding": 0.02}

    def __init__(self, image_size: int = 224, patch_size: int = 16, hidden_size: int = 768,
                 num_layers: int = 12, num_heads: int = 12, mlp_dim: int = 3072,
                 num_classes: int = 1000):
        super().__init__()
        if image_size % patch_size:
            raise ValueError("the reference takes images a whole number of patches wide")
        self.patch = patch_size
        self.conv_proj = nn.Conv2d(3, hidden_size, patch_size, patch_size)
        self.class_token = nn.Parameter(torch.zeros(1, 1, hidden_size))
        tokens = (image_size // patch_size) ** 2 + 1
        self.encoder = Encoder(tokens, hidden_size, num_layers, num_heads, mlp_dim)
        self.heads = nn.ModuleDict({"head": nn.Linear(hidden_size, num_classes)})

    @classmethod
    def from_sizes(cls, sizes: dict) -> "ViT":
        """The model of a configuration's ``model`` sizes."""
        return cls(sizes["image_size"], sizes["patch_size"], sizes["hidden_size"],
                   sizes["num_layers"], sizes["num_heads"], sizes["mlp_dim"],
                   sizes["num_classes"])

    @property
    def classifier(self) -> nn.Linear:
        return self.heads["head"]

    def features(self, x: torch.Tensor) -> torch.Tensor:
        """The class token's final row ``[B, hidden]`` of NCHW images."""
        h = self.conv_proj(x).flatten(2).transpose(1, 2)
        h = torch.cat([self.class_token.expand(h.shape[0], -1, -1), h], dim=1)
        h = h + self.encoder.pos_embedding
        for block in self.encoder.layers.values():
            h = block(h)
        return layer_norm(h[:, 0], self.encoder.ln)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.classifier(self.features(x))
