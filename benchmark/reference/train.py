"""One plain training step of NBDT's SoftTreeSupLoss with SGD, and the
batch it trains on.

The loss is the upstream ``nbdt/loss.py`` ``SoftTreeSupLoss``: the
cross-entropy of the backbone's logits plus the cross-entropy of the soft
rules' class probabilities used as logits, each weighted 1. The update is
``torch.optim.SGD``'s rule with momentum and weight decay, written out:
``d = g + wd * p``, ``buf = d`` on the first step and ``m * buf + d`` after,
``p -= lr * buf``.

The batch is gathered from a uint8 NHWC store and augmented as CIFAR
training is (zero padding of 4, a random 32x32 crop, a random horizontal
flip) at draws the caller gives, then normalized by the configuration's
mean and standard deviation on the 0-255 scale, ``(x - 255 mean) / (255
std)``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def draws(gen: torch.Generator, batch: int, pad: int):
    """The crop offsets ``[B, 2]`` (row, column) and flips ``[B]`` of one
    step, in the order the training step draws them from its generator."""
    offsets = torch.randint(0, 2 * pad + 1, (batch, 2), generator=gen, device=gen.device)
    flips = torch.rand(batch, generator=gen, device=gen.device) < 0.5
    return offsets, flips


def batch(images, labels, idx, offsets, flips, pad: int, mean, std):
    """NCHW f32 images and labels of one step."""
    x = images[idx]
    H, W = x.shape[1:3]
    xp = F.pad(x, (0, 0, pad, pad, pad, pad))
    crops = [xp[b, r:r + H, c:c + W] for b, (r, c) in enumerate(offsets.tolist())]
    x = torch.stack(crops)
    x = torch.where(flips[:, None, None, None], x.flip(2), x)
    mean = torch.tensor(mean, device=x.device) * 255.0
    scale = 1.0 / (torch.tensor(std, device=x.device) * 255.0)
    x = (x.float() - mean) * scale
    return x.permute(0, 3, 1, 2).contiguous(), labels[idx]


class SoftTreeSupSGD:
    """The reference's training state: the model, its momentum buffers and
    the optimizer's settings."""

    def __init__(self, model, rules, lr: float, momentum: float, weight_decay: float):
        self.model, self.rules = model, rules
        self.lr, self.momentum, self.wd = lr, momentum, weight_decay
        self.params = dict(model.named_parameters())
        self.buffers = {}

    def loss(self, x, y):
        logits = self.model(x)
        return F.cross_entropy(logits, y) + F.cross_entropy(self.rules.probs(logits), y)

    def step(self, x, y):
        """One step in place; returns (loss, {name: gradient})."""
        self.model.train()
        loss = self.loss(x, y)
        grads = torch.autograd.grad(loss, list(self.params.values()))
        with torch.no_grad():
            for (name, p), g in zip(self.params.items(), grads):
                d = g + self.wd * p
                buf = self.buffers.get(name)
                buf = d.clone() if buf is None else buf.mul_(self.momentum).add_(d)
                self.buffers[name] = buf
                p.sub_(self.lr * buf)
        return loss.detach(), dict(zip(self.params, grads))
