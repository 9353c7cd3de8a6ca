"""Trainer CLI: argparse -> data -> model -> tree -> loss -> trainer.

Counterpart of ``nbdt_tpu/main.py``, with its whole flag surface:

    python -m nbdt_torch.main --synthetic --dataset CIFAR10 --arch ResNet18 \\
        --loss SoftTreeSupLoss --epochs 1

Runs on the CUDA card unless ``--device cpu``. A flag whose module is still
to be ported exits with an error that names its ROADMAP item. The NBDT
accuracy of a trained backbone, as the reference evaluates it:

    python -m nbdt_torch.main --dataset TinyImagenet200 --arch wrn28_10 \
        --hierarchy induced-wrn28_10 --eval --checkpoint-path ckpt.pth \
        --analysis SoftEmbeddedDecisionRules

EfficientNet-B7b on the Imagenet1000 induced tree (``BASELINE.json``
config #4), at the dataset's 224px:

    python -m nbdt_torch.main --dataset Imagenet1000 --arch efficientnet_b7b \
        --hierarchy induced-efficientnet_b7b --eval --checkpoint-path ckpt.pth \
        --analysis SoftEmbeddedDecisionRules

Zero-shot: train without some classes, then score another dataset's test
set in a superclass label space (WordNet offline through a mini-corpus):

    python -m nbdt_torch.main --dataset CIFAR10 --arch vit_b16 \
        --exclude-labels 3 5 --loss SoftTreeSupLoss --hierarchy wordnet
    python -m nbdt_torch.main --dataset CIFAR10 --arch vit_b16 --eval \
        --checkpoint-path ckpt.pth --dataset-test CIFAR100 --disable-test-eval \
        --analysis SuperclassNBDT --superclass-wnids n00015388 n04524313 \
        --mini-corpus corpus.json
"""

from __future__ import annotations

import argparse
import os

# Flags whose modules the port does not have yet, and the ROADMAP item that
# brings each.
NOT_PORTED = {
    "mesh": "A13",
    "zero": "A13",
    "multihost": "A13",
    "profile": "A16",
}


def get_parser() -> argparse.ArgumentParser:
    from . import analysis, losses, metrics
    from .models import MODEL_REGISTRY
    from .utils import DATASETS

    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--dataset", default="CIFAR10", choices=DATASETS)
    parser.add_argument("--arch", default="ResNet18", choices=sorted(MODEL_REGISTRY))
    parser.add_argument("--epochs", "-e", default=200, type=int)
    parser.add_argument("--batch-size", default=512, type=int)
    parser.add_argument("--lr", default=0.1, type=float)
    parser.add_argument("--loss", default="CrossEntropyLoss", choices=list(losses.names))
    parser.add_argument("--metric", default="top1", choices=metrics.names)
    parser.add_argument("--analysis", default=None, choices=[None, *analysis.names],
                        help="analyzer run beside the eval")
    parser.add_argument("--resume", action="store_true")
    parser.add_argument("--path-resume", default="")
    parser.add_argument("--eval", action="store_true")
    parser.add_argument("--pretrained", action="store_true",
                        help="start from the released reference checkpoint of (arch, "
                             "dataset[, hierarchy]), read from the local cache "
                             "($NBDT_CHECKPOINT_DIR) and fetched only when missing, or "
                             "from --checkpoint-path")
    parser.add_argument("--checkpoint-path", default=None,
                        help="local reference .pth, or the JAX package's .msgpack, loaded "
                             "strictly into the backbone")
    parser.add_argument("--name", default="")
    parser.add_argument("--data-root", default="./data")
    parser.add_argument("--download", action="store_true",
                        help="refused: the port downloads nothing")
    parser.add_argument("--synthetic", action="store_true",
                        help="use a synthetic dataset (offline smoke runs)")
    parser.add_argument("--dataset-test", default=None)
    parser.add_argument("--disable-test-eval", action="store_true")
    parser.add_argument("--checkpoint-dir", default="./checkpoint")
    parser.add_argument("--mini-corpus", default=None,
                        help="vendored mini WordNet (a corpus table JSON or a vendored "
                             "wordnet hierarchy JSON): runs the Superclass hypernym mapping "
                             "and the WordNet flows offline")
    parser.add_argument("--cache-dataset", action="store_true",
                        help="upload the uint8 train set to the device once and gather, "
                             "augment and normalize there")
    parser.add_argument("--cache-crop-pad", type=int, default=4,
                        help="cached-mode random-crop padding in pixels (0: no crop)")
    parser.add_argument("--no-cache-flip", action="store_true",
                        help="cached mode: no random horizontal flip")
    parser.add_argument("--checkpoint-backend", default="pth", choices=("pth", "orbax"),
                        help="pth: the model's state dict; orbax: not ported yet (A13)")
    # tree
    parser.add_argument("--hierarchy", default=None)
    parser.add_argument("--path-graph", default=None)
    parser.add_argument("--path-wnids", default=None)
    # loss weights
    parser.add_argument("--xent-weight", "--xw", type=float, default=1.0)
    parser.add_argument("--xent-weight-end", "--xwe", type=float, default=None)
    parser.add_argument("--xent-weight-power", "--xwp", type=float, default=1.0)
    parser.add_argument("--tree-supervision-weight", "--tsw", type=float, default=1.0)
    parser.add_argument("--tree-supervision-weight-end", "--tswe", type=float, default=None)
    parser.add_argument("--tree-supervision-weight-power", "--tswp", type=float, default=1.0)
    parser.add_argument("--tree-start-epochs", "--tse", type=int, default=67)
    parser.add_argument("--tree-update-every-epochs", "--tueve", type=int, default=10)
    parser.add_argument("--tree-update-end-epochs", "--tuene", type=int, default=120)
    # data subsets
    parser.add_argument("--include-labels", nargs="*", type=int, default=())
    parser.add_argument("--exclude-labels", nargs="*", type=int, default=())
    parser.add_argument("--include-classes", nargs="*", type=str, default=())
    parser.add_argument("--probability-labels", default=None)
    # analysis
    parser.add_argument("--superclass-wnids", nargs="*", type=str, default=None)
    parser.add_argument("--save-k", type=int, default=20)
    parser.add_argument("--visualize-decision-node-wnid", "--vdnw", default=None)
    parser.add_argument("--device", default="cuda", help="torch device (default: cuda)")
    parser.add_argument("--profile", default=None, metavar="DIR", help="not ported yet (A16)")
    parser.add_argument("--remat", action="store_true",
                        help="recompute the forward in the backward (memory for FLOPs)")
    parser.add_argument("--bf16", action="store_true",
                        help="bf16 backbone (params, BatchNorm, losses and node decisions "
                             "stay f32)")
    parser.add_argument("--bn-impl", default="auto", choices=["auto", "f32", "bf16"],
                        help="BatchNorm compute dtype (ResNet and WRN): f32, or bf16 (the "
                             "stream dtype); auto takes bf16 at 64px and above")
    parser.add_argument("--mesh", action="store_true", help="not ported yet (A13)")
    parser.add_argument("--zero", action="store_true", help="not ported yet (A13)")
    parser.add_argument("--device-normalize", action="store_true",
                        help="ship raw uint8 batches and normalize on the device")
    parser.add_argument("--no-progress", action="store_true",
                        help="no per-step progress bar (it syncs the device every step)")
    parser.add_argument("--multihost", action="store_true", help="not ported yet (A13)")
    parser.add_argument("--coordinator-address", default=None)
    parser.add_argument("--num-processes", type=int, default=None)
    parser.add_argument("--process-id", type=int, default=None)
    return parser


def refuse_not_ported(args) -> None:
    """Exit with an error naming the ROADMAP item of every flag that needs a
    module the port does not have yet."""
    from .analysis import NOT_PORTED as ANALYZERS_NOT_PORTED

    for flag, item in NOT_PORTED.items():
        if getattr(args, flag):
            raise SystemExit(f"error: --{flag.replace('_', '-')} is not ported to nbdt_torch "
                             f"yet (ROADMAP {item})")
    if args.analysis in ANALYZERS_NOT_PORTED:
        raise SystemExit(f"error: --analysis {args.analysis} is not ported to nbdt_torch yet "
                         f"(ROADMAP {ANALYZERS_NOT_PORTED[args.analysis]})")
    if args.checkpoint_backend == "orbax":
        raise SystemExit("error: --checkpoint-backend orbax is not ported to nbdt_torch yet "
                         "(ROADMAP A13)")


def resolve_bn_impl(bn_impl: str, module, image: int) -> str:
    """``--bn-impl auto`` -> bf16 for images of 64px and above on a backbone
    with the knob (``bn_impl``: the ResNets and the WRN), else f32, as the
    JAX CLI resolves it; an explicit f32 or bf16 passes through."""
    if bn_impl != "auto":
        return bn_impl
    return "bf16" if image >= 64 and hasattr(module, "bn_impl") else "f32"


def build_datasets(args):
    """The train and test sets, wrapped by the label-subset flags. An
    explicit ``--dataset-test`` names its own test distribution and stays
    unwrapped (resampling is a train-only augmentation either way)."""
    from .data import SyntheticDataset, get_dataset, wrap_dataset
    from .utils import DATASET_TO_NUM_CLASSES, default_image_size

    if args.synthetic:
        n = DATASET_TO_NUM_CLASSES[args.dataset]
        n_test = DATASET_TO_NUM_CLASSES.get(args.dataset_test or args.dataset, n)
        size = default_image_size(args.dataset)
        trainset = SyntheticDataset(n, size=4 * args.batch_size, image_size=size)
        testset = SyntheticDataset(n_test, size=2 * args.batch_size, image_size=size, seed=1)
    else:
        trainset = get_dataset(args.dataset)(root=args.data_root, train=True,
                                             download=args.download)
        testset = get_dataset(args.dataset_test or args.dataset)(
            root=args.data_root, train=False, download=args.download)
    # getattr: a hand-built namespace may leave the subset flags out
    subset = {k: getattr(args, k, ()) for k in ("include_labels", "exclude_labels",
                                                 "include_classes")}
    trainset = wrap_dataset(trainset, probability_labels=getattr(args, "probability_labels", None),
                            **subset)
    if not args.dataset_test:
        testset = wrap_dataset(testset, **subset)
    if list(trainset.classes) != list(testset.classes) and not args.disable_test_eval:
        raise SystemExit("error: train/test class mismatch requires --disable-test-eval: "
                         f"{trainset.classes[:5]}... vs {testset.classes[:5]}...")
    return trainset, testset


def build_analyzer(args, tree, testset, device):
    """The ``--analysis`` plugin: rules-driven analyzers get the live tree
    and the run's device, score savers ``--save-k``."""
    if args.analysis is None:
        return None
    import inspect

    from . import analysis

    cls = getattr(analysis, args.analysis)
    if cls is analysis.Noop:
        return cls(classes=testset.classes)
    if cls is analysis.ConfusionMatrix:
        return cls(testset.classes)
    params = inspect.signature(cls.__init__).parameters
    kwargs = {}
    if issubclass(cls, analysis.ScoreSave) and getattr(args, "save_k", None) is not None:
        kwargs["save_k"] = args.save_k
    if "tree" in params:
        kwargs["tree"] = tree
    if "device" in params:
        kwargs["device"] = device
    if issubclass(cls, analysis.Superclass):
        if args.superclass_wnids is None:
            raise SystemExit(f"error: --analysis {args.analysis} needs --superclass-wnids (the "
                             "hypernym wnids defining the superclass label space)")
        kwargs["superclass_wnids"] = args.superclass_wnids
        if args.dataset_test and args.dataset_test != args.dataset:
            kwargs["dataset_test"] = args.dataset_test
    if cls is analysis.VisualizeDecisionNode:
        if not args.visualize_decision_node_wnid:
            raise SystemExit("error: --analysis VisualizeDecisionNode needs "
                             "--visualize-decision-node-wnid")
        kwargs["visualize_decision_node_wnid"] = args.visualize_decision_node_wnid
    return cls(**kwargs)


def main(argv=None):
    args = get_parser().parse_args(argv)
    refuse_not_ported(args)

    import torch

    from .data import DataLoader, PrefetchLoader
    from .model import load_checkpoint, pretrained_checkpoint
    from .models import get_model
    from .trainer import TrainConfig, Trainer
    from .tree import Tree
    from .utils import Colors, default_image_size, hierarchy_to_path_graph, resolve_device

    device = resolve_device(args.device)
    if args.mini_corpus:
        from .hierarchy.wnid import install_mini_corpus

        install_mini_corpus(args.mini_corpus)
    trainset, testset = build_datasets(args)
    torch.manual_seed(0)
    image = default_image_size(args.dataset)
    model = get_model(args.arch, len(trainset.classes), image_size=image)
    args.bn_impl = resolve_bn_impl(args.bn_impl, model, image)
    if args.bn_impl != "f32":
        if not hasattr(model, "bn_impl"):
            raise SystemExit(f"--bn-impl is only supported by the ResNet/WRN families, not "
                             f"{args.arch}")
        source, model = model, model.clone(bn_impl=args.bn_impl)
        model.load_state_dict(source.state_dict())
    if args.pretrained or args.checkpoint_path:
        # The plain-backbone tables overwrite the NBDT table on the (arch,
        # dataset) key, as in the JAX CLI; a hierarchy's key exists only in
        # the NBDT table and wins when present.
        from .model import model_urls as nbdt_urls
        from .models import resnet, wideresnet

        urls = {**nbdt_urls, **wideresnet.model_urls, **resnet.model_urls}
        path = pretrained_checkpoint(args.arch, args.dataset, args.hierarchy,
                                     args.checkpoint_path, urls)
        model.load_state_dict(load_checkpoint(path, arch=args.arch), strict=True)
        Colors.green(f"==> Loaded pretrained weights for {args.arch}/{args.dataset} from "
                     f"{path}")

    tree = None
    if args.loss != "CrossEntropyLoss" or args.analysis:
        path_graph = args.path_graph
        if args.hierarchy and not path_graph:
            path_graph = hierarchy_to_path_graph(args.dataset, args.hierarchy)
        if path_graph is None:  # induce from the fresh model's classifier
            from .hierarchy.generate import generate_hierarchy

            path_graph = generate_hierarchy(dataset=args.dataset, method="induced",
                                            arch=args.arch, model=model,
                                            hierarchies_root=args.checkpoint_dir)
        tree = Tree(args.dataset, path_graph=path_graph, path_wnids=args.path_wnids,
                    classes=list(trainset.classes))

    config = TrainConfig(
        dataset=args.dataset,
        arch=args.arch,
        batch_size=args.batch_size,
        epochs=args.epochs,
        lr=args.lr,
        loss=args.loss,
        tree_supervision_weight=args.tree_supervision_weight,
        tree_supervision_weight_end=args.tree_supervision_weight_end,
        tree_supervision_weight_power=args.tree_supervision_weight_power,
        xent_weight=args.xent_weight,
        xent_weight_end=args.xent_weight_end,
        xent_weight_power=args.xent_weight_power,
        hierarchy=args.hierarchy,
        path_graph=tree.path_graph if tree else None,
        path_wnids=args.path_wnids,
        checkpoint_dir=args.checkpoint_dir,
        cache_dataset=args.cache_dataset,
        cache_crop_pad=args.cache_crop_pad,
        cache_flip=not args.no_cache_flip,
        include_labels=tuple(args.include_labels or ()),
        exclude_labels=tuple(args.exclude_labels or ()),
        include_classes=tuple(args.include_classes or ()),
        name=args.name,
        metric=args.metric,
        disable_test_eval=args.disable_test_eval,
        remat=args.remat,
        bf16=args.bf16,
        tree_start_epochs=args.tree_start_epochs,
        tree_update_every_epochs=args.tree_update_every_epochs,
        tree_update_end_epochs=args.tree_update_end_epochs,
    )

    device_normalize = device_normalize_eval = None
    if args.device_normalize:
        for ds, which in ((trainset, args.dataset), (testset, args.dataset_test or args.dataset)):
            if not (hasattr(ds, "mean") and hasattr(ds, "std")):
                raise SystemExit(f"error: --device-normalize: {which} exposes no mean/std "
                                 "normalization constants")
        device_normalize = (trainset.mean, trainset.std)
        device_normalize_eval = (testset.mean, testset.std)
    dn = {"device_normalize": True} if device_normalize else {}
    # torch DataLoader semantics: the short last batch trains too
    trainloader = PrefetchLoader(DataLoader(
        trainset, args.batch_size, shuffle=True,
        transform=trainset.transform_train(**dn) if hasattr(trainset, "transform_train")
        else None,
        drop_last=False))
    testloader = DataLoader(
        testset, args.batch_size, shuffle=False,
        transform=testset.transform_val(**dn) if hasattr(testset, "transform_val") else None,
        drop_last=False, pad_last=True)
    analyzer = build_analyzer(args, tree, testset, device)
    if args.disable_test_eval and args.analysis in (None, "Noop"):
        Colors.red("WARNING: --disable-test-eval turns off the standard test metric; pass "
                   "--analysis to define one.")
    trainer = Trainer(
        config, model, trainloader, testloader, tree=tree, analyzer=analyzer,
        show_progress=not args.no_progress,
        device_normalize=device_normalize, device_normalize_eval=device_normalize_eval,
        inverse_transform=testset.transform_val_inverse()
        if hasattr(testset, "transform_val_inverse") else None,
        device=device,
    )
    if args.loss == "SoftTreeLoss":  # regenerate the induced tree from the live model
        from .losses import SoftTreeLoss

        trainer.criterion_state = SoftTreeLoss(
            tree=tree, arch=args.arch, checkpoint_path=args.checkpoint_dir,
            model_fn=lambda: trainer.model, tree_start_epochs=args.tree_start_epochs,
            tree_update_every_epochs=args.tree_update_every_epochs,
            tree_update_end_epochs=args.tree_update_end_epochs,
            tree_supervision_weight=args.tree_supervision_weight, device=device)

    if args.resume or args.path_resume:
        candidates = [args.path_resume] if args.path_resume else [
            os.path.join(args.checkpoint_dir, trainer.checkpoint_fname() + suffix + ".pth")
            for suffix in ("-last", "")]
        path = next((p for p in candidates if p and os.path.exists(p)), None)
        if path:
            trainer.load(path)
            Colors.green(f"==> Resumed from {path} (epoch {trainer.start_epoch})")
        else:
            Colors.red(f"==> No checkpoint at {candidates[-1]}; starting fresh")

    if args.eval:
        if analyzer is not None:
            analyzer.start_epoch(0)
        acc = trainer.evaluate(0, checkpoint=False)
        if analyzer is not None:
            analyzer.end_epoch(0)
        if args.disable_test_eval and hasattr(analyzer, "accuracy"):
            acc = analyzer.accuracy  # the analyzer defines the metric
        Colors.green(f"==> Eval accuracy: {acc:.2f}%")
        return acc
    best = trainer.fit()
    Colors.green(f"==> Best accuracy: {best:.2f}%")
    return best


if __name__ == "__main__":
    main()
