"""Training loop: SGD steps with the tree-supervision losses.

Counterpart of ``nbdt_tpu/trainer.py`` (the reference's ``main.py``
semantics): SGD with momentum 0.9 and weight decay 5e-4, the learning rate
dropped 10x at the first step of epochs int(3E/7) and int(5E/7), batch 512,
best-accuracy checkpoints, analyzers on the duck-typed hooks.

Where the JAX package jit-compiles a functional step over donated buffers,
the port trains an ``nn.Module`` and a ``torch.optim.SGD`` in place, eagerly:
forward, loss (the tree term through the plain rules, exact f32 in both
passes), backward, update. The SGD update is the optax chain's
(``add_decayed_weights`` -> ``trace`` -> learning rate), and the learning
rate of step ``i`` (0-based) is ``piecewise_constant_schedule`` at ``i``, as
optax reads its step count before it increments it. A tree refresh swaps
the tree constants; nothing is compiled.

Two modes, as in the JAX package: host-fed (the loader's batches move to
the device each step) and cached (``cache_dataset``: the uint8 store is
uploaded once and the step gathers, augments and normalizes on the device;
its permutation and augment draws come from a ``torch.Generator``, so they
are not JAX's bits). Inputs are NHWC; the model sees an NCHW view.
Checkpoints are a ``.pth`` state dict beside the JAX package's ``.json``
meta.
"""

from __future__ import annotations

import copy
import json
import os
import time
from dataclasses import dataclass
from typing import Callable, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from .losses import (cross_entropy, hard_tree_sup_loss, hard_tree_sup_loss_custom,
                     scheduled_weight, soft_tree_sup_loss)
from .rules import DeviceTreeArrays, to_device_tree
from .utils import Colors, generate_checkpoint_fname, progress_bar, resolve_device


@dataclass
class TrainConfig:
    dataset: str = "CIFAR10"
    arch: str = "ResNet18"
    batch_size: int = 512
    epochs: int = 200
    lr: float = 0.1
    momentum: float = 0.9
    weight_decay: float = 5e-4
    loss: str = "SoftTreeSupLoss"  # CrossEntropyLoss | SoftTreeSupLoss | HardTreeSupLoss | SoftTreeLoss
    tree_supervision_weight: float = 1.0
    tree_supervision_weight_end: Optional[float] = None
    tree_supervision_weight_power: float = 1.0
    xent_weight: float = 1.0
    xent_weight_end: Optional[float] = None
    xent_weight_power: float = 1.0
    hierarchy: Optional[str] = None
    path_graph: Optional[str] = None
    path_wnids: Optional[str] = None
    checkpoint_dir: str = "./checkpoint"
    name: str = ""
    metric: str = "top1"  # top1 | top2 | top5 | top10
    # Zero-shot runs: skip the standard test metric (the analyzer scores).
    disable_test_eval: bool = False
    seed: int = 0
    remat: bool = False  # recompute the forward in the backward (torch.utils.checkpoint)
    bf16: bool = False  # backbone under bf16 autocast; losses and tree math stay f32
    # Upload the uint8 train store to the device once; the step gathers,
    # augments and normalizes there.
    cache_dataset: bool = False
    # Label-subset flags, kept so that the checkpoint name encodes them.
    include_labels: tuple = ()
    exclude_labels: tuple = ()
    include_classes: tuple = ()
    cache_crop_pad: int = 4  # random-crop padding of the device augment
    cache_flip: bool = True  # random horizontal flip of the device augment
    cache_steps_per_call: int = 16  # optimizer steps a cached step call runs
    # Write a rolling "<fname>-last" checkpoint every epoch as well.
    save_last: bool = True
    # SoftTreeLoss schedule
    tree_start_epochs: int = 67
    tree_update_every_epochs: int = 10
    tree_update_end_epochs: int = 120


def lr_boundaries(epochs: int, steps_per_epoch: int) -> dict:
    """Step boundaries of the two 10x drops, at the first step of epochs
    int(3E/7) and int(5E/7) (milestones that meet compound)."""
    steps_per_epoch = max(1, steps_per_epoch)
    boundaries: dict = {}
    for milestone_epoch in (int(epochs * 3 / 7), int(epochs * 5 / 7)):
        step = milestone_epoch * steps_per_epoch
        boundaries[step] = boundaries.get(step, 1.0) * 0.1
    return boundaries


def lr_schedule(config: TrainConfig, steps_per_epoch: int) -> Callable[[int], float]:
    """The learning rate of step ``i`` (0-based): the initial rate times
    the scale of every boundary at or below ``i``."""
    boundaries = sorted(lr_boundaries(config.epochs, steps_per_epoch).items())

    def lr_at(step: int) -> float:
        lr = config.lr
        for boundary, scale in boundaries:
            if step >= boundary:
                lr *= scale
        return lr

    return lr_at


def make_optimizer(config: TrainConfig, params) -> torch.optim.SGD:
    """SGD with momentum and weight decay (no dampening, no Nesterov): the
    update of optax's add_decayed_weights -> trace -> learning rate. The
    trainer sets each step's learning rate from :func:`lr_schedule`."""
    return torch.optim.SGD(params, lr=config.lr, momentum=config.momentum,
                           weight_decay=config.weight_decay)


def tree_term_fn(loss_name: str, jt: Optional[DeviceTreeArrays], tsw: float,
                 criterion_fn: Optional[Callable] = None, pre_start: bool = False) -> Callable:
    """The tree component of the total loss, by loss name.

    HardTreeSupLoss carries tsw here and again through the scheduled tree
    weight (the reference's quirk). ``pre_start`` (SoftTreeLoss only): before
    ``tree_start_epochs`` the tree term is the base criterion itself, so the
    total is criterion * (xw + tw). ``criterion_fn`` is the base criterion
    (cross-entropy by default)."""
    criterion = criterion_fn or cross_entropy
    if loss_name in ("CrossEntropyLoss", None, ""):
        return lambda logits, targets: 0.0
    if jt is None:
        raise ValueError(f"{loss_name} requires a tree")
    if loss_name == "SoftTreeLoss" and pre_start:
        return criterion
    if loss_name in ("SoftTreeSupLoss", "SoftTreeLoss"):
        return lambda logits, targets: soft_tree_sup_loss(logits, targets, jt,
                                                          criterion=criterion)
    if loss_name == "HardTreeSupLoss":
        if criterion is cross_entropy:
            return lambda logits, targets: hard_tree_sup_loss(logits, targets, jt,
                                                              tree_supervision_weight=tsw)
        return lambda logits, targets: hard_tree_sup_loss_custom(
            logits, targets, jt, criterion=criterion, tree_supervision_weight=tsw)
    raise KeyError(f"Unknown loss {loss_name!r}")


def _normalize_prologue(normalize, device) -> Callable:
    """Device-side normalization of uint8 batches (identity when None), the
    JAX package's formula: ``(x - 255 mean) * (1 / (255 std))`` in f32."""
    if normalize is None:
        return lambda x: x
    mean = torch.as_tensor(np.asarray(normalize[0], np.float32) * 255.0, device=device)
    inv = torch.as_tensor(1.0 / (np.asarray(normalize[1], np.float32) * 255.0), device=device)
    return lambda x: (x.float() - mean) * inv


def _unwrap_loader(loader):
    """The DataLoader under prefetch wrappers."""
    while hasattr(loader, "loader"):
        loader = loader.loader
    return loader


def draw_augment(generator: torch.Generator, batch: int, crop_pad: int, flip: bool):
    """Random crop offsets ``[B, 2]`` (row, column) in ``[0, 2 crop_pad]``
    and flips ``[B]`` for :func:`_device_augment`, on the generator's
    device."""
    dev = generator.device
    offsets = torch.randint(0, 2 * crop_pad + 1, (batch, 2), generator=generator, device=dev)
    flips = (torch.rand(batch, generator=generator, device=dev) < 0.5) if flip else None
    return offsets, flips


def _device_augment(x: torch.Tensor, offsets: Optional[torch.Tensor],
                    flips: Optional[torch.Tensor], crop_pad: int) -> torch.Tensor:
    """Pad + crop + flip of a uint8 NHWC batch on its device, at explicit
    draws: image b is cropped from the ``crop_pad``-padded batch at rows
    ``offsets[b, 0]``, columns ``offsets[b, 1]``, then mirrored where
    ``flips[b]`` (two axis-wise gathers, as in the JAX package)."""
    B, H, W, C = x.shape
    if crop_pad:
        xp = F.pad(x, (0, 0, crop_pad, crop_pad, crop_pad, crop_pad))
        rows = offsets[:, :1] + torch.arange(H, device=x.device)[None]  # [B, H]
        cols = offsets[:, 1:] + torch.arange(W, device=x.device)[None]  # [B, W]
        x = xp.gather(1, rows[:, :, None, None].expand(B, H, xp.shape[2], C))
        x = x.gather(2, cols[:, None, :, None].expand(B, H, W, C))
    if flips is not None:
        x = torch.where(flips[:, None, None, None], x.flip(2), x)
    return x


def _bn_buffers(model: torch.nn.Module):
    return [b for m in model.modules() if isinstance(m, torch.nn.modules.batchnorm._BatchNorm)
            for b in m.buffers()]


def _remat(model: torch.nn.Module) -> Callable:
    """The model's forward through ``torch.utils.checkpoint``: activations
    are recomputed in the backward. The recompute leaves the BatchNorm
    running statistics as the forward left them (they update once a step,
    as in JAX, where the recompute is pure)."""
    from torch.utils.checkpoint import checkpoint, set_checkpoint_early_stop

    def run(x, state):
        if not state:
            state.append(True)
            return model(x)
        saved = [b.clone() for b in _bn_buffers(model)]
        out = model(x)
        with torch.no_grad():
            for b, s in zip(_bn_buffers(model), saved):
                b.copy_(s)
        return out

    def forward(x):
        with set_checkpoint_early_stop(False):  # the recompute runs to the end, restore included
            return checkpoint(run, x, [], use_reentrant=False)

    return forward


def make_train_step(model: torch.nn.Module, optimizer: torch.optim.Optimizer,
                    lr_at: Callable[[int], float], loss_name: str,
                    jt: Optional[DeviceTreeArrays], tsw: float = 1.0, remat: bool = False,
                    criterion_fn: Optional[Callable] = None, pre_start: bool = False,
                    normalize=None, cached: bool = False, batch_size: Optional[int] = None,
                    crop_pad: int = 4, flip: bool = True, steps_per_call: int = 1,
                    bf16: bool = False):
    """The train step, which updates ``model`` and ``optimizer`` in place.

    Host-fed: ``step(x, y, tree_weight, xent_weight, count) -> metrics`` on
    device tensors ``x`` (NHWC; uint8 when ``normalize`` is set, which the
    step then applies) and ``y``; ``count`` is the optimizer step, which
    picks the learning rate.

    ``cached=True``: ``step(images, labels, perm, step_i, generator,
    tree_weight, xent_weight, count) -> [metrics]`` runs ``steps_per_call``
    steps: step j takes indices ``perm[(step_i + j) * batch_size:][:batch_size]``
    of the device-resident uint8 store, augments them at draws from
    ``generator`` (:func:`draw_augment`) and normalizes them.

    Metrics are device tensors (no sync): ``loss``, ``loss_xent``,
    ``loss_tree``, ``acc`` and the batch's ``logits``.
    """
    criterion = criterion_fn or cross_entropy
    tree_term = tree_term_fn(loss_name, jt, tsw, criterion_fn=criterion, pre_start=pre_start)
    device = next(model.parameters()).device
    prologue = _normalize_prologue(normalize, device)
    forward = _remat(model) if remat else model

    def core(x, y, tree_weight, xent_weight, count):
        for group in optimizer.param_groups:
            group["lr"] = lr_at(count)
        model.train()
        with torch.autocast(device.type, dtype=torch.bfloat16, enabled=bf16):
            logits = forward(x.permute(0, 3, 1, 2))
        logits = logits.float()
        loss_x = criterion(logits, y)
        loss_t = tree_term(logits, y)
        total = loss_x * xent_weight + loss_t * tree_weight
        optimizer.zero_grad(set_to_none=True)
        total.backward()
        optimizer.step()
        logits = logits.detach()
        return {
            "loss": total.detach(),
            "loss_xent": loss_x.detach(),
            "loss_tree": loss_t.detach() if torch.is_tensor(loss_t) else torch.zeros(()),
            "acc": (logits.argmax(-1) == y).float().mean(),
            "logits": logits,
        }

    if not cached:
        def step(x, y, tree_weight, xent_weight, count):
            return core(prologue(x), y, tree_weight, xent_weight, count)

        return step

    if normalize is None or batch_size is None:
        raise ValueError("cached=True needs normalize=(mean, std) for the uint8 store and "
                         "batch_size")

    def cached_step(images, labels, perm, step_i, generator, tree_weight, xent_weight, count):
        out = []
        for j in range(steps_per_call):
            idx = perm[(step_i + j) * batch_size:(step_i + j + 1) * batch_size]
            x = images.index_select(0, idx)
            y = labels.index_select(0, idx)
            offsets, flips = draw_augment(generator, batch_size, crop_pad, flip)
            x = _device_augment(x, offsets if crop_pad else None, flips, crop_pad)
            m = core(prologue(x), y, tree_weight, xent_weight, count + j)
            m.pop("logits")
            out.append(m)
        return out

    return cached_step


def _batch_hit_counts(model, prologue, x, y, valid, k, analyzer_fwd, analyzer_k):
    """One batch's masked top-k hit counts (and an analyzer's), the one
    definition the host-fed and cached evals share."""
    logits = model(prologue(x).permute(0, 3, 1, 2)).float()

    def topk_hits(scores, kk):
        kk = min(kk, scores.shape[-1])
        topk = scores.topk(kk, dim=-1).indices
        return ((topk == y[:, None]).any(-1) & valid).sum()

    ahits = topk_hits(analyzer_fwd(logits), analyzer_k) if analyzer_fwd is not None else None
    return topk_hits(logits, k), ahits, valid.sum()


def make_cached_eval_count_step(model, k: int, batch_size: int, n_batches: int, device,
                                normalize=None, analyzer_fwd=None, analyzer_k: int = 1):
    """The whole eval over a device-resident test store padded to
    ``n_batches * batch_size`` rows with a validity mask: hit counts as
    device scalars."""
    prologue = _normalize_prologue(normalize, device)

    @torch.no_grad()
    def step(images, labels, valid):
        model.eval()
        hits = ahits = total = 0
        for i in range(n_batches):
            s = slice(i * batch_size, (i + 1) * batch_size)
            h, a, c = _batch_hit_counts(model, prologue, images[s], labels[s], valid[s], k,
                                        analyzer_fwd, analyzer_k)
            hits, total = hits + h, total + c
            if a is not None:
                ahits = ahits + a
        return hits, ahits, total

    return step


def make_eval_step(model, device, normalize=None):
    prologue = _normalize_prologue(normalize, device)

    @torch.no_grad()
    def step(x):
        model.eval()
        return model(prologue(x).permute(0, 3, 1, 2)).float()

    return step


def make_eval_count_step(model, k: int, device, normalize=None, analyzer_fwd=None,
                         analyzer_k: int = 1):
    """Top-k hit counting on the device: returns device scalars (hits[,
    analyzer hits], count), padded rows masked by ``valid``, so the eval
    loop syncs once at its end. ``analyzer_fwd`` (an analyzer's
    ``device_eval``) re-scores the same logits."""
    prologue = _normalize_prologue(normalize, device)

    @torch.no_grad()
    def step(x, y, valid):
        model.eval()
        hits, ahits, total = _batch_hit_counts(model, prologue, x, y, valid, k, analyzer_fwd,
                                               analyzer_k)
        return (hits, total) if ahits is None else (hits, ahits, total)

    return step


class Trainer:
    """End-to-end trainer (the reference's main.py semantics) on ``device``
    (CUDA unless the caller passes ``device="cpu"``). It trains a private
    copy of ``model``; :attr:`model` is the live one."""

    def __init__(
        self,
        config: TrainConfig,
        model: torch.nn.Module,
        trainloader,
        testloader,
        tree=None,
        analyzer=None,
        criterion_state=None,
        show_progress: bool = False,
        criterion_fn: Optional[Callable] = None,
        inverse_transform: Optional[Callable] = None,
        device_normalize=None,
        device_normalize_eval=None,
        device="cuda",
    ):
        """``device_normalize``: ``(mean, std)`` in [0, 1] units: the loaders
        ship raw uint8 batches and the steps normalize on the device;
        ``device_normalize_eval`` overrides it for the test set."""
        self.device = resolve_device(device)
        self.show_progress = show_progress
        self.config = config
        self.model = copy.deepcopy(model).to(self.device, memory_format=torch.channels_last)
        self.trainloader = trainloader
        self.testloader = testloader
        self.tree = tree
        self.analyzer = analyzer
        self.inverse_transform = inverse_transform
        self.criterion_state = criterion_state

        if tree is None and config.loss != "CrossEntropyLoss":
            if not (config.path_graph or config.hierarchy):
                raise ValueError(f"{config.loss} needs a hierarchy: pass tree=, or set "
                                 "TrainConfig.path_graph / TrainConfig.hierarchy")
            from .tree import Tree

            dataset = _unwrap_loader(trainloader).dataset
            tree = Tree(config.dataset, path_graph=config.path_graph,
                        path_wnids=config.path_wnids,
                        classes=list(getattr(dataset, "classes", []) or []) or None,
                        hierarchy=config.hierarchy)
            self.tree = tree
        self.jt = None
        if tree is not None and config.loss != "CrossEntropyLoss":
            self.jt = to_device_tree(tree.arrays, self.device)

        self.criterion_fn = criterion_fn
        self.device_normalize = device_normalize
        self.device_normalize_eval = (device_normalize_eval if device_normalize_eval is not None
                                      else device_normalize)
        # Plain DecisionRules analyzers score on the device (device_eval);
        # any other analyzer needs the host loader path.
        self._use_cache = config.cache_dataset and (
            analyzer is None or (hasattr(analyzer, "device_eval")
                                 and analyzer.device_eval() is not None))
        # The schedule counts the steps that run: a cached epoch takes
        # floor(n / B) whole batches, len(loader) counts the short last one.
        self._steps_per_epoch = max(1, len(trainloader))
        if self._use_cache:
            n_train = len(_unwrap_loader(trainloader).dataset)
            self._steps_per_epoch = max(1, n_train // config.batch_size)
        self.lr_at = lr_schedule(config, self._steps_per_epoch)
        self.optimizer = make_optimizer(config, self.model.parameters())
        self.step_count = 0  # optimizer steps taken: the learning-rate schedule's step
        self._pre_start = config.loss == "SoftTreeLoss" and config.tree_start_epochs > 0
        self._cached_train = None
        self._cached_test = None
        self._cached_n = 0
        self._store_normalize = None
        self._store_normalize_eval = None
        if config.cache_dataset:
            if not self._use_cache:
                Colors.red("==> cache_dataset disabled: analyzer "
                           f"{type(analyzer).__name__} needs per-batch host images/logits "
                           "(no device_eval)")
            else:
                self._upload_stores(trainloader, testloader)
        self.train_step = self._make_step(self.jt)
        self.eval_step = make_eval_step(self.model, self.device,
                                        normalize=self.device_normalize_eval)
        self.best_acc = 0.0
        self.start_epoch = 0

    def _upload_stores(self, trainloader, testloader) -> None:
        """The uint8 train store and the test store (padded to whole batches,
        with a validity mask) on the device, with their normalize constants."""
        if self.analyzer is not None:
            Colors.cyan("==> cache_dataset + device analyzer: NBDT accuracy is "
                        "device-counted at eval; train-batch analyzer updates are skipped")
        images, labels = self._materialize_uint8(trainloader)
        if self.device_normalize is not None:
            self._store_normalize = self.device_normalize
        else:
            ds = _unwrap_loader(trainloader).dataset
            self._store_normalize = (ds.mean, ds.std)
        if self.device_normalize_eval is not None:
            self._store_normalize_eval = self.device_normalize_eval
        else:
            tds = _unwrap_loader(testloader).dataset
            self._store_normalize_eval = ((tds.mean, tds.std) if hasattr(tds, "mean")
                                          else self._store_normalize)

        def put(a):
            return torch.as_tensor(np.ascontiguousarray(a)).to(self.device)

        self._cached_train = (put(images), put(labels.astype(np.int64)))
        self._cached_n = len(labels)
        ti, tl_ = self._materialize_uint8(testloader)
        B = self.config.batch_size
        nb = (len(tl_) + B - 1) // B
        pad = nb * B - len(tl_)
        tv = np.ones(len(tl_), bool)
        if pad:
            ti = np.concatenate([ti, np.zeros((pad,) + ti.shape[1:], np.uint8)])
            tl_ = np.concatenate([tl_, np.zeros(pad, tl_.dtype)])
            tv = np.concatenate([tv, np.zeros(pad, bool)])
        self._cached_test = (put(ti), put(tl_.astype(np.int64)), put(tv), nb)

    @property
    def criterion_state(self):
        return self._criterion_state

    @criterion_state.setter
    def criterion_state(self, cs):
        """Records the criterion's device tree when it is assigned, so that a
        refresh on its very first ``set_epoch`` (a resume that lands on a
        refresh epoch) is seen as a change."""
        self._criterion_state = cs
        self._criterion_jt = getattr(cs, "jt", None)

    def _make_step(self, jt, steps_per_call: Optional[int] = None):
        c = self.config
        kw = dict(tsw=c.tree_supervision_weight, remat=c.remat, criterion_fn=self.criterion_fn,
                  pre_start=self._pre_start, bf16=c.bf16)
        if self._cached_train is not None:
            steps = self._cached_n // c.batch_size
            K = steps_per_call or max(1, min(c.cache_steps_per_call, steps))
            self._cached_K = K
            rest = steps % K

            def build(k):
                return make_train_step(self.model, self.optimizer, self.lr_at, c.loss, jt,
                                       normalize=self._store_normalize, cached=True,
                                       batch_size=c.batch_size, crop_pad=c.cache_crop_pad,
                                       flip=c.cache_flip, steps_per_call=k, **kw)

            self._train_step_rest = build(rest) if rest else None
            return build(K)
        return make_train_step(self.model, self.optimizer, self.lr_at, c.loss, jt,
                               normalize=self.device_normalize, **kw)

    @staticmethod
    def _materialize_uint8(loader):
        """Full (uint8 images [N, H, W, C], labels) of a loader's dataset: the
        DataLoader's flat arrays (a subset wrapper's index applied to the
        images; its labels are already remapped), else one pass over
        ``dataset[i]``."""
        loader = _unwrap_loader(loader)
        if getattr(loader, "images", None) is not None:
            images = loader.images
            index = getattr(loader, "_index", None)
            if index is not None:
                images = images[index]
            return np.ascontiguousarray(images), np.asarray(loader.labels)
        ds = loader.dataset
        samples = [ds[i] for i in range(len(ds))]
        images = np.stack([s[0] for s in samples])
        if images.dtype != np.uint8:
            raise ValueError(f"cache_dataset needs raw uint8 samples, got {images.dtype}")
        return images, np.asarray([s[1] for s in samples])

    def _put(self, a) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a)).to(self.device)

    def _weights(self, epoch: int) -> Tuple[float, float]:
        """(tree weight, xent weight) of an epoch. SoftTreeLoss's pre-start
        keeps the tree weight on its schedule: the step's tree term is the
        criterion then."""
        c = self.config
        progress = epoch / c.epochs if c.epochs else 1.0

        def sched(start, end, power):
            return scheduled_weight(start, end if end is not None else start, progress, power)

        return (sched(c.tree_supervision_weight, c.tree_supervision_weight_end,
                      c.tree_supervision_weight_power),
                sched(c.xent_weight, c.xent_weight_end, c.xent_weight_power))

    def train_epoch(self, epoch: int) -> dict:
        """One epoch; returns the last step's metrics as floats, the epoch's
        ``time`` and every step's loss (``step_losses``)."""
        tw, xw = self._weights(epoch)
        want_pre = self.config.loss == "SoftTreeLoss" and epoch < self.config.tree_start_epochs
        if want_pre != self._pre_start:  # SoftTreeLoss's warm-up ends
            self._pre_start = want_pre
            self.train_step = self._make_step(self.jt)
        if self.criterion_state is not None:
            self.criterion_state.set_epoch(epoch, self.config.epochs)
            # a SoftTreeLoss refresh regenerated the tree from the live model
            new_jt = getattr(self.criterion_state, "jt", None)
            if new_jt is not None and new_jt is not self._criterion_jt:
                self._criterion_jt = new_jt
                self.jt = new_jt
                self.train_step = self._make_step(new_jt)
        if self._cached_train is not None:
            return self._train_epoch_cached(epoch, tw, xw)
        t0 = time.time()
        last, losses = {}, []
        n_batches = len(self.trainloader)
        if self.analyzer is not None:
            self.analyzer.start_train(epoch)
        for i, (x, y, valid) in enumerate(self.trainloader):
            m = self.train_step(self._put(x), self._put(y).long(), tw, xw, self.step_count)
            self.step_count += 1
            logits = m.pop("logits")
            last = m
            losses.append(m["loss"])
            if self.analyzer is not None:
                self.analyzer.update_batch(logits.cpu().numpy(), np.asarray(y),
                                           self._analyzer_images(x))
            if self.show_progress:
                progress_bar(i, n_batches, f"Loss: {float(m['loss']):.3f} | "
                                           f"Acc: {float(m['acc']) * 100:.2f}%")
        if self.analyzer is not None:
            self.analyzer.end_train(epoch)
        return self._epoch_stats(last, losses, t0)

    def _train_epoch_cached(self, epoch: int, tw: float, xw: float) -> dict:
        """Device-resident epoch: only a step index, the generator and the
        weights cross from the host; the permutation is drawn on the device."""
        t0 = time.time()
        B = self.config.batch_size
        steps = self._cached_n // B
        if steps == 0:
            raise ValueError(f"cache_dataset: batch {B} exceeds dataset size {self._cached_n}")
        gen = torch.Generator(device=self.device)
        gen.manual_seed(self.config.seed * 1_000_003 + epoch)
        perm = torch.randperm(self._cached_n, generator=gen, device=self.device)
        images, labels = self._cached_train
        K = self._cached_K
        n_calls = steps // K
        ms = []
        for c in range(n_calls):
            ms += self.train_step(images, labels, perm, c * K, gen, tw, xw, self.step_count)
            self.step_count += K
            if self.show_progress:
                progress_bar(c, n_calls, f"Loss: {float(ms[-1]['loss']):.3f} | "
                                         f"Acc: {float(ms[-1]['acc']) * 100:.2f}%")
        if self._train_step_rest is not None:
            rest = steps - n_calls * K
            ms += self._train_step_rest(images, labels, perm, n_calls * K, gen, tw, xw,
                                        self.step_count)
            self.step_count += rest
        return self._epoch_stats(ms[-1], [m["loss"] for m in ms], t0)

    @staticmethod
    def _epoch_stats(last: dict, losses: list, t0: float) -> dict:
        stats = {k: float(v) for k, v in last.items()}  # one sync an epoch
        stats["step_losses"] = torch.stack(losses).tolist() if losses else []
        stats["time"] = time.time() - t0
        return stats

    def _analyzer_images(self, x) -> np.ndarray:
        """[0, 1] pixels for analyzer hooks: uint8 batches rescaled, normalized
        ones un-normalized by ``inverse_transform``."""
        imgs = np.asarray(x)
        if imgs.dtype == np.uint8:
            return imgs.astype(np.float32) / 255.0
        if self.inverse_transform is not None:
            imgs = np.asarray(self.inverse_transform(imgs))
        return imgs

    def evaluate(self, epoch: int = 0, checkpoint: bool = True) -> float:
        from . import metrics

        metric = getattr(metrics, self.config.metric)()
        start_ep = getattr(self.analyzer, "start_epoch", None)
        if start_ep is not None and getattr(self.analyzer, "epoch", None) is None:
            start_ep(epoch)
        analyzer_dev = None
        if self.analyzer is not None and hasattr(self.analyzer, "device_eval"):
            analyzer_dev = self.analyzer.device_eval()
        fast = ((self.analyzer is None or analyzer_dev is not None)
                and not self.config.disable_test_eval and isinstance(metric, metrics.TopK))
        if fast:  # hit counts on the device, a few ints pulled at the end
            fwd, ak = analyzer_dev if analyzer_dev else (None, 1)
            if self.analyzer is not None:
                self.analyzer.start_test(epoch)
            if self._cached_test is not None:
                imgs, lbls, valid, nb = self._cached_test
                count = make_cached_eval_count_step(
                    self.model, metric.k, self.config.batch_size, nb, self.device,
                    normalize=self._store_normalize_eval, analyzer_fwd=fwd, analyzer_k=ak)
                h, a, t = count(imgs, lbls, valid)
            else:
                count = make_eval_count_step(self.model, metric.k, self.device,
                                             normalize=self.device_normalize_eval,
                                             analyzer_fwd=fwd, analyzer_k=ak)
                h = a = t = 0
                for x, y, v in self.testloader:
                    res = count(self._put(x), self._put(y).long(), self._put(v))
                    h, t = h + res[0], t + res[-1]
                    if fwd is not None:
                        a = a + res[1]
            metric.correct, metric.total = int(h), int(t)
            if self.analyzer is not None:
                if analyzer_dev is not None:
                    self.analyzer.metric.correct = int(a)
                    self.analyzer.metric.total = metric.total
                self.analyzer.end_test(epoch)
            return self._finish_eval(metric, epoch, checkpoint)
        if self.analyzer is not None:
            self.analyzer.start_test(epoch)
        for x, y, valid in self.testloader:
            logits_np = self.eval_step(self._put(x)).cpu().numpy()[valid]
            y_np = np.asarray(y)[valid]
            if not self.config.disable_test_eval:
                metric.forward(logits_np, y_np)
            if self.analyzer is not None:
                self.analyzer.update_batch(logits_np, y_np,
                                           self._analyzer_images(np.asarray(x)[valid]))
        if self.analyzer is not None:
            self.analyzer.end_test(epoch)
        return self._finish_eval(metric, epoch, checkpoint)

    def _finish_eval(self, metric, epoch: int, checkpoint: bool) -> float:
        """Report, and save when the accuracy beats the best."""
        acc = metric.report() * 100.0
        if checkpoint and acc > self.best_acc:
            self.best_acc = acc
            self.save(epoch, acc)
        return acc

    def fit(self, log_every: int = 1) -> float:
        for epoch in range(self.start_epoch, self.config.epochs):
            if self.analyzer is not None:
                self.analyzer.start_epoch(epoch)
            stats = self.train_epoch(epoch)
            acc = self.evaluate(epoch)
            if self.config.save_last:
                self.save(epoch + 1, acc, suffix="-last")  # a resume starts after this epoch
            if self.analyzer is not None:
                self.analyzer.end_epoch(epoch)
            if epoch % log_every == 0:
                Colors.cyan(f"[epoch {epoch}] loss={stats.get('loss', 0):.4f} "
                            f"train_acc={stats.get('acc', 0) * 100:.2f}% test_acc={acc:.2f}% "
                            f"best={self.best_acc:.2f}% ({stats.get('time', 0):.1f}s)")
        return self.best_acc

    def checkpoint_fname(self) -> str:
        c = self.config
        return generate_checkpoint_fname(
            dataset=c.dataset, arch=c.arch, path_graph=c.path_graph, loss=[c.loss], lr=c.lr,
            name=c.name, tree_supervision_weight=c.tree_supervision_weight,
            tree_supervision_weight_end=c.tree_supervision_weight_end,
            tree_supervision_weight_power=c.tree_supervision_weight_power,
            xent_weight=c.xent_weight, xent_weight_end=c.xent_weight_end,
            xent_weight_power=c.xent_weight_power,
            include_labels=tuple(c.include_labels or ()),
            exclude_labels=tuple(c.exclude_labels or ()),
            include_classes=tuple(c.include_classes or ()),
        )

    def save(self, epoch: int, acc: float, suffix: str = "") -> str:
        """Write ``<fname><suffix>.pth`` (the model's state dict) and its
        ``.json`` meta; ``suffix`` "-last" is the rolling per-epoch one."""
        os.makedirs(self.config.checkpoint_dir, exist_ok=True)
        path = os.path.join(self.config.checkpoint_dir, self.checkpoint_fname() + suffix)
        torch.save({k: v.detach().cpu() for k, v in self.model.state_dict().items()},
                   path + ".pth")
        with open(path + ".json", "w") as f:
            # best_acc too: the "-last" checkpoint holds this epoch's accuracy
            json.dump({"acc": acc, "epoch": epoch, "arch": self.config.arch,
                       "best_acc": max(self.best_acc, acc)}, f)
        return path + ".pth"

    def load(self, path: str) -> None:
        """Restore the model from a ``.pth`` written by :meth:`save`. The
        momentum restarts (the reference stores only the net), and the
        learning-rate schedule moves on to the resumed epoch's first step."""
        state = torch.load(path, map_location=self.device, weights_only=True)
        self.model.load_state_dict(state, strict=True)
        self.optimizer = make_optimizer(self.config, self.model.parameters())
        meta_path = path[: -len(".pth")] + ".json" if path.endswith(".pth") else path + ".json"
        if os.path.exists(meta_path):
            with open(meta_path) as f:
                meta = json.load(f)
            self.best_acc = meta.get("best_acc", meta.get("acc", 0.0))
            self.start_epoch = meta.get("epoch", 0)
        self.step_count = self.start_epoch * self._steps_per_epoch
        self.train_step = self._make_step(self.jt)
