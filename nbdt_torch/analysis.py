"""Analyzer plugins: epoch-lifecycle eval instrumentation.

Counterpart of ``nbdt_tpu/analysis.py``. Every analyzer derives from
``Noop`` with ``start/end_{epoch,train,test}`` hooks and a per-batch
``update_batch(outputs, targets, images)``. Analyzers take host numpy arrays
(or CPU tensors), as the trainer hands them over; their host math is the
JAX package's numpy. The rules-driven analyzers hold the port's decision
rules on ``device`` (CUDA unless the caller passes ``device="cpu"``), and
``DecisionRules.device_eval`` gives the trainer the rules' pure forward so
that the NBDT accuracy is counted on the device. ``Superclass`` and
``SuperclassNBDT`` score a zero-shot run in a superclass label space on the
host, as in the JAX package.
"""

from __future__ import annotations

import os
import time
from collections import defaultdict
from functools import partial
from pathlib import Path
from typing import List

import numpy as np

from . import metrics
from .hierarchy.wnid import synset_to_wnid, wnid_to_synset
from .rules import HardEmbeddedDecisionRules as HardRules
from .rules import SoftEmbeddedDecisionRules as SoftRules
from .rules import hard_forward, soft_forward
from .utils import Colors

__all__ = names = (
    "Noop",
    "ConfusionMatrix",
    "IgnoredSamples",
    "HardEmbeddedDecisionRules",
    "SoftEmbeddedDecisionRules",
    "Entropy",
    "Superclass",
    "SuperclassNBDT",
    "VisualizeDecisionNode",
    "NBDTEntropyMaxMin",
    "NBDTEntropyBottom",
    "TopEntropy",
    "TopDifference",
    "VisualizeHierarchyInference",
)

# Analyzers whose modules the port does not have yet: none is left.
NOT_PORTED: dict = {}


def _host(x) -> np.ndarray:
    """Host numpy of an array or a tensor on any device."""
    return x.detach().cpu().numpy() if hasattr(x, "detach") else np.asarray(x)


def _softmax(x, axis=-1):
    x = x - x.max(axis=axis, keepdims=True)
    e = np.exp(x)
    return e / e.sum(axis=axis, keepdims=True)


def _entropy(probs, axis=-1):
    p = np.clip(probs, 1e-30, 1.0)
    return -(p * np.log(p)).sum(axis=axis)


class StartEndContext:
    def __init__(self, obj, name, epoch=0):
        self.obj = obj
        self.name = name
        self.epoch = epoch

    def __call__(self, epoch):
        self.epoch = epoch
        return self

    def __enter__(self):
        return getattr(self.obj, f"start_{self.name}")(self.epoch)

    def __exit__(self, type, value, traceback):
        getattr(self.obj, f"end_{self.name}")(self.epoch)


class Noop:
    """Base lifecycle plugin."""

    def __init__(self, classes=()):
        self.classes = list(classes)
        self.num_classes = len(self.classes)
        self.epoch = None

    @property
    def epoch_context(self):
        return StartEndContext(self, "epoch")

    def start_epoch(self, epoch):
        self.epoch = epoch

    def start_train(self, epoch):
        pass

    def update_batch(self, outputs, targets, images=None):
        self._update_batch(outputs, targets)

    def _update_batch(self, outputs, targets):
        pass

    def end_train(self, epoch):
        pass

    def start_test(self, epoch):
        pass

    def end_test(self, epoch):
        pass

    def end_epoch(self, epoch):
        pass


class ConfusionMatrix(Noop):
    """Per-class recall and precision."""

    def __init__(self, classes):
        super().__init__(classes)
        self.k = len(classes)
        self.m = None

    def start_test(self, epoch):
        self.m = np.zeros((self.k, self.k))

    def _update_batch(self, outputs, targets):
        predicted = _host(outputs).argmax(1).ravel()
        targets = _host(targets).ravel()
        np.add.at(self.m, (targets, predicted), 1)

    def end_test(self, epoch):
        recall = self.recall()
        for row, cls in zip(recall, self.classes):
            print(row, cls)
        print(recall.diagonal(), "(diagonal)")

    @staticmethod
    def normalize(m, axis):
        total = m.astype(np.float64).sum(axis=axis)
        total = total[:, None] if axis == 1 else total[None]
        return m / np.maximum(total, 1e-12)

    def recall(self):
        return ConfusionMatrix.normalize(self.m, 1)

    def precision(self):
        return ConfusionMatrix.normalize(self.m, 0)


class IgnoredSamples(Noop):
    """Counter of ignored (-1-marked) samples."""

    def __init__(self, classes=()):
        super().__init__(classes)
        self.ignored = None

    def start_test(self, epoch):
        self.ignored = 0

    def _update_batch(self, outputs, targets):
        self.ignored += int((_host(outputs)[:, 0] == -1).sum())
        return self.ignored

    def end_test(self, epoch):
        print("Ignored Samples: {}".format(self.ignored))


class DecisionRules(Noop):
    """Re-run the NBDT rules over backbone logits, tracking the NBDT
    accuracy apart from the backbone's."""

    name = "NBDT"
    Rules = HardRules

    def __init__(self, *args, Rules=None, tree=None, metric="top1", device="cuda", **kwargs):
        self.rules = (Rules or self.Rules)(*args, tree=tree, device=device, **kwargs)
        super().__init__(self.rules.tree.classes)
        self.metric = getattr(metrics, metric)()
        self.best_accuracy = 0.0
        self._device_fwd = None

    def start_test(self, epoch):
        self.metric.clear()

    def _update_batch(self, outputs, targets):
        self.metric.forward(_host(self.rules.forward(outputs)), _host(targets))
        return self.accuracy

    def device_eval(self):
        """``(logits -> scores, k)`` for counting this analyzer's top-k hits
        on the device, in the trainer's eval step beside the backbone's, or
        None where the analyzer does per-batch host work of its own. The
        forward is the rules' pure ``soft_forward``/``hard_forward`` bound to
        their ``DeviceTreeArrays``."""
        cls = type(self)
        if (cls._update_batch is not DecisionRules._update_batch
                or cls.update_batch is not Noop.update_batch
                or not isinstance(self.metric, metrics.TopK)):
            return None
        if self._device_fwd is None:
            fwd = soft_forward if isinstance(self.rules, SoftRules) else hard_forward
            self._device_fwd = partial(fwd, jt=self.rules.jt)
        return self._device_fwd, self.metric.k

    @property
    def accuracy(self) -> float:
        """The analyzer's accuracy in percent."""
        return round(self.metric.report() * 100.0, 2)

    def end_test(self, epoch):
        accuracy = self.accuracy
        self.best_accuracy = max(accuracy, self.best_accuracy)
        print(
            f"[{self.name}] Accuracy: {accuracy}%, {self.metric.correct}/"
            f"{self.metric.total} | {self.name} Best Accuracy: "
            f"{self.best_accuracy}%"
        )


class HardEmbeddedDecisionRules(DecisionRules):
    name = "NBDT-Hard"
    Rules = HardRules


class SoftEmbeddedDecisionRules(DecisionRules):
    name = "NBDT-Soft"
    Rules = SoftRules


class ScoreSave(Noop):
    """Keep the top-k and bottom-k scored images and write them as JPEGs at
    the end of a test. Images arrive as NHWC uint8, or float in [0, 1]; pass
    ``inverse_transform`` for normalized ones."""

    def __init__(
        self,
        classes=(),
        save_k: int = 20,
        path: str = "out/score-{epoch}-{time}/image-{suffix}-{i}-{score:.2e}.jpg",
        inverse_transform=None,
        **kwargs,
    ):
        super().__init__(classes)
        self.k = save_k
        self.path = Path(path)
        self.time = int(time.time())
        self.inverse_transform = inverse_transform
        self.reset()

    def start_test(self, epoch):
        self.reset()

    def reset(self):
        self.max: List = []
        self.min: List = []

    def score(self, outputs, targets, images):
        raise NotImplementedError()

    def update_batch(self, outputs, targets, images=None):
        self._update_batch(outputs, targets)
        scores = self.score(outputs, targets, images)
        if images is None:
            images = [None] * len(scores)
        ois = list(zip(list(_host(outputs)), list(images), scores))
        key = lambda t: t[-1]  # noqa: E731
        self.max = sorted(self.max + ois, reverse=True, key=key)[: self.k]
        self.min = sorted(self.min + ois, key=key)[: self.k]

    def end_test(self, epoch):
        directory = str(self.path.parent).format(time=self.time, epoch=self.epoch)
        os.makedirs(directory, exist_ok=True)
        try:
            from PIL import Image
        except ImportError:
            return
        for name, suffix, lst in (("highest", "max", self.max), ("lowest", "min", self.min)):
            print(f"==> Saving {len(lst)} {name} scored images in {directory}")
            for i, (_, image, score) in enumerate(lst):
                if image is None:
                    continue
                img = _host(image)
                if self.inverse_transform is not None:
                    img = self.inverse_transform(img)
                # The pixel contract: uint8 is written as it is; float must
                # be un-normalized [0, 1] (the trainer's _analyzer_images
                # guarantees it), else the dump would be garbage.
                if img.dtype != np.uint8:
                    lo, hi = float(img.min()), float(img.max())
                    if lo < -0.01 or hi > 1.01:
                        raise ValueError(
                            f"{type(self).__name__} received float images outside [0,1] "
                            f"(range [{lo:.3g}, {hi:.3g}]): pass the dataset's "
                            "transform_val_inverse() as inverse_transform= so dumps are "
                            "un-normalized.")
                    img = np.clip(img * 255.0, 0, 255)
                Image.fromarray(img.astype(np.uint8)).save(str(self.path).format(
                    epoch=self.epoch, i=i, suffix=suffix, score=score, time=self.time))


class Entropy(ScoreSave):
    """Output-entropy statistics (Welford running mean and variance) and
    the extreme samples."""

    def __init__(self, classes=(),
                 path="out/entropy-{epoch}-{time}/image-{suffix}-{i}-{score:.2e}.jpg", **kwargs):
        super().__init__(classes, path=path, **kwargs)

    def reset(self):
        super().reset()
        self.avg = 0.0
        self.std = 0.0
        self.i = 0

    def score(self, outputs, targets, images):
        return list(_entropy(_softmax(_host(outputs))))

    def update_batch(self, outputs, targets, images=None):
        super().update_batch(outputs, targets, images)
        for e_i in _entropy(_softmax(_host(outputs))):
            self.i += 1
            prev = self.avg
            self.avg = prev + ((e_i - prev) / self.i)
            self.std = self.std + (e_i - prev) * (e_i - self.avg)

    def end_test(self, epoch):
        super().end_test(epoch)
        mx = float(self.max[0][-1]) if self.max else float("nan")
        mn = float(self.min[0][-1]) if self.min else float("nan")
        print(f"[Entropy] avg {self.avg:.2e}, std {self.std:.2e}, max {mx:.2e}, min {mn:.2e}")


class NBDTEntropyMaxMin(Entropy):
    """Score = the spread of the decision path's entropies."""

    def __init__(self, *args, Rules=HardRules, path_graph=None, path_wnids=None,
                 dataset=None, tree=None, device="cuda",
                 path="out/entropy-nbdt-{epoch}-{time}/image-{suffix}-{i}-{score:.2e}.jpg",
                 **kwargs):
        super().__init__(*args, path=path, **kwargs)
        self.rules = Rules(path_graph=path_graph, path_wnids=path_wnids, dataset=dataset,
                           tree=tree, device=device)

    def score(self, outputs, targets, images):
        _, decisions = self.rules.forward_with_decisions(_host(outputs))
        entropies = [[node["entropy"] for node in path] for path in decisions]
        return [max(ent) - min(ent) for ent in entropies]


class NBDTEntropyBottom(NBDTEntropyMaxMin):
    """Score = the gap between the two smallest path entropies, for every
    sample (the reference scores only the last one)."""

    def score(self, outputs, targets, images):
        _, decisions = self.rules.forward_with_decisions(_host(outputs))
        scores = []
        for path in decisions:
            entropies = sorted(node["entropy"] for node in path)
            bot1, bot2 = entropies[:2] if len(entropies) >= 2 else (0.0, 0.0)
            scores.append(bot2 - bot1)
        return scores


class TopEntropy(Entropy):
    """Entropy of the two smallest probabilities against the rest."""

    def score(self, outputs, targets, images):
        sorted_probs = np.sort(_softmax(_host(outputs)), axis=1)
        top2 = _entropy(sorted_probs[:, :2])
        rest = np.concatenate(
            [sorted_probs[:, :2].mean(axis=1, keepdims=True), sorted_probs[:, 2:]], axis=1)
        return list(top2 - _entropy(rest))


class TopDifference(ScoreSave):
    """The top-2 probability margin."""

    def score(self, outputs, targets, images):
        sorted_probs = np.sort(_softmax(_host(outputs)), axis=1)
        return list(sorted_probs[:, -1] - sorted_probs[:, -2])


class VisualizeDecisionNode(ScoreSave):
    """Save the samples most similar to a chosen decision node: the score is
    the node's raw child logit toward the chosen wnid (a per-sample softmax
    would reorder the ranking across samples). With ``superclass_wnids``,
    samples whose label maps to no superclass score 0."""

    def __init__(self, *args, visualize_decision_node_wnid, tree=None, Rules=SoftRules,
                 dataset=None, path_graph=None, path_wnids=None, superclass_wnids=None,
                 device="cuda", path="out/vdn-{epoch}-{time}/image-{suffix}-{i}-{score:.2e}.jpg",
                 **kwargs):
        super().__init__(*args, path=path, **kwargs)
        self.rules = Rules(tree=tree, dataset=dataset, path_graph=path_graph,
                           path_wnids=path_wnids, device=device)
        self.wnid = visualize_decision_node_wnid
        self.mapping_target = None
        if superclass_wnids:
            self.mapping_target, _ = Superclass.build_mapping(
                self.rules.tree.wnids_leaves, list(superclass_wnids))

    def score(self, outputs, targets, images):
        tree = self.rules.tree
        parent = tree.wnid_to_node[self.wnid].parent
        assert parent is not None, f"{self.wnid} has no parent"
        out = self.rules.forward_nodes(_host(outputs))[parent.wnid]
        similarity = np.asarray(out["logits"][:, parent.wnid_to_child_index(self.wnid)],
                                dtype=float)
        if self.mapping_target is not None and targets is not None:
            mapped = self.mapping_target[_host(targets)]
            similarity = np.where(mapped >= 0, similarity, 0.0)
        return list(similarity)


class Superclass(DecisionRules):
    """Zero-shot superclass eval: map the prediction classes and the test
    classes onto ``superclass_wnids`` through their WordNet hypernym
    closures, mask the logits of unmapped classes, and compare in
    superclass space. ``mapping`` (leaf wnid -> superclass index) replaces
    the WordNet closure for both class spaces; ``mapping_test`` replaces it
    for the test label space only, where an unseen class maps to a
    superclass without being in the prediction space. ``dataset_test`` or
    ``tree_test`` give the test label space its own tree. Scored on the
    host: ``device_eval`` is None."""

    name = "Superclass"
    Rules = SoftRules

    def __init__(self, *args, superclass_wnids, dataset_test=None, Rules=None, tree=None,
                 tree_test=None, metric=None, mapping=None, mapping_test=None, device="cuda",
                 **kwargs):
        super().__init__(*args, tree=tree, Rules=Rules or self.Rules, device=device, **kwargs)
        if tree_test is not None or dataset_test is not None:
            self.rules_test = (Rules or self.Rules)(dataset=dataset_test, tree=tree_test,
                                                    device=device)
        else:
            self.rules_test = self.rules
        self.superclass_wnids = list(superclass_wnids)
        self.total = self.correct = 0

        def resolve(wnids_leaves, mapping):
            if mapping is None:
                return self.build_mapping(wnids_leaves, self.superclass_wnids)
            new_to_old = defaultdict(list)
            arr = []
            for old_index, w in enumerate(wnids_leaves):
                value = int(mapping.get(w, -1))
                arr.append(value)
                new_to_old[value].append(old_index)
            return np.array(arr), new_to_old

        self.mapping_target, self.new_to_old_classes_target = resolve(
            self.rules_test.tree.wnids_leaves, mapping if mapping_test is None else mapping_test)
        self.mapping_pred, self.new_to_old_classes_pred = resolve(
            self.rules.tree.wnids_leaves, mapping)
        mapped = [self.classes[i] for i in np.flatnonzero(self.mapping_pred >= 0)
                  if i < len(self.classes)]
        if not mapped:
            Colors.red("WARNING: 0 classes mapped to your superclasses — every sample will be "
                       "skipped and accuracy will read 0%. Offline (no WordNet corpus), pass "
                       "mapping= or --mini-corpus, or use leaf wnids as superclass wnids.")
        else:
            Colors.cyan(f"==> Mapped {len(mapped)} classes to your superclasses: {mapped}")

    @staticmethod
    def build_mapping(dataset_wnids, superclass_wnids):
        """(leaf index -> index of the first superclass among its WordNet
        hypernyms, or -1; superclass index -> leaf indices), through the
        installed WordNet corpus or mini-corpus."""
        new_to_old_classes = defaultdict(list)
        mapping = []
        for old_index, dataset_wnid in enumerate(dataset_wnids):
            hypernym_wnids = [synset_to_wnid(s)
                              for s in Superclass.all_hypernyms(wnid_to_synset(dataset_wnid))]
            value = next((i for i, w in enumerate(superclass_wnids) if w in hypernym_wnids), -1)
            mapping.append(value)
            new_to_old_classes[value].append(old_index)
        return np.array(mapping), new_to_old_classes

    @staticmethod
    def all_hypernyms(synset):
        """The synset and its hypernyms, breadth first."""
        hypernyms, frontier = [], [synset]
        while frontier:
            current = frontier.pop(0)
            hypernyms.append(current)
            frontier.extend(current.hypernyms())
        return hypernyms

    def forward(self, outputs, targets):
        """(predicted superclass, target superclass) of the samples whose
        target maps to a superclass; the argmax runs over the mapped
        classes' logits only."""
        outputs = np.array(_host(outputs), copy=True)
        targets = self.mapping_target[_host(targets)]
        outputs = outputs[targets >= 0]
        targets = targets[targets >= 0]
        outputs[:, self.mapping_pred < 0] = -100
        if outputs.shape[0] == 0:
            return np.array([]), np.array([])
        return self.mapping_pred[outputs.argmax(1)], targets

    def start_test(self, epoch):
        self.total = self.correct = 0

    @property
    def accuracy(self) -> float:
        return round(self.correct / (float(self.total) or 1) * 100.0, 2)

    def _update_batch(self, outputs, targets):
        predicted, targets = self.forward(outputs, targets)
        self.total += len(predicted)
        self.correct += int((predicted == targets).sum())
        return f"{self.name}: {self.accuracy}%"

    def end_test(self, epoch):
        print(f"[{self.name}] Accuracy: {self.accuracy}%, {self.correct}/{self.total}")


class SuperclassNBDT(Superclass):
    """Scores each superclass by the mean of its member classes' logits."""

    name = "Superclass-NBDT"
    Rules = SoftRules

    def forward(self, outputs, targets):
        outputs = _host(outputs)
        num_super = max((k for k in self.new_to_old_classes_pred if k >= 0), default=-1) + 1
        if num_super == 0:  # nothing mapped (the constructor warned): 0 predictions
            return np.zeros(0, np.int64), np.zeros(0, np.int64)
        cols = []
        for k in range(num_super):
            old = self.new_to_old_classes_pred.get(k, [])
            cols.append(outputs[:, old].mean(axis=1) if old else np.full(len(outputs), -1e30))
        predicted = np.stack(cols, axis=1).argmax(1)
        targets = self.mapping_target[_host(targets)]
        return predicted[targets >= 0], targets[targets >= 0]


class VisualizeHierarchyInference(Noop):
    """Writes one hierarchy HTML per sample (up to ``limit`` a test) with
    the soft rules' per-edge probabilities along its decision path."""

    def __init__(self, classes=(), tree=None, Rules=SoftRules, dataset=None, path_graph=None,
                 path_wnids=None, out_dir="out/vis-inference", limit: int = 8, device="cuda",
                 **kwargs):
        self.rules = Rules(tree=tree, dataset=dataset, path_graph=path_graph,
                           path_wnids=path_wnids, device=device)
        super().__init__(self.rules.tree.classes)
        self.out_dir = out_dir
        self.limit = limit
        self._written = 0

    def start_test(self, epoch):
        self._written = 0

    def update_batch(self, outputs, targets, images=None):
        if self._written >= self.limit:
            return
        from .hierarchy.vis import generate_hierarchy_vis_from

        _, decisions = self.rules.forward_with_decisions(_host(outputs))
        os.makedirs(self.out_dir, exist_ok=True)
        for decision in decisions:
            if self._written >= self.limit:
                break
            path_html = os.path.join(self.out_dir, f"sample-{self.epoch}-{self._written}.html")
            generate_hierarchy_vis_from(
                self.rules.tree.G, dataset=self.rules.tree.dataset, path_html=path_html,
                color_path_to=decision[-1]["node"].wnid,
                edge_probs={step["node"].wnid: step["prob"] for step in decision})
            self._written += 1
