"""Released-checkpoint parity harness: checkpoint -> converter -> dual-report
eval -> decision-path transcript -> verdict, in one command.

Counterpart of ``tools/verify_release.py``. It holds a released NBDT
checkpoint (reference README.md:431-438) to its published top-1 and, with
``--reference-transcript``, its decision paths to a saved transcript:

    python -m nbdt_torch.tools.verify_release \\
        --checkpoint ckpt-CIFAR10-wrn28_10_cifar10.pth \\
        --arch wrn28_10_cifar10 --dataset CIFAR10 --dataset-root ./data

Pipeline: the checkpoint (a reference ``.pth`` or the JAX package's
``.msgpack``) loads through ``SoftNBDT(pretrained=True)``; one backbone pass
per batch gives the backbone, soft-NBDT and hard-NBDT top-1 (reference
main.py:261-308 semantics), f32 with TF32 off, the node decisions exact f32;
the first ``--transcript-n`` val images get their decision paths; the soft
top-1 is held to the published table within ``--tolerance`` (the README
grants 0.1-0.2 points). Prints PASS or FAIL and exits 0 (pass, or report
only) or 1 (a mismatch). Runs on the CUDA card unless ``--device cpu``.

``--val synthetic`` runs the same path on a seeded synthetic val set, with
no files staged. The JSON report (``--report-out``) has the JAX tool's keys
and transcript fields, so a report written by either tool is accepted as
the other's ``--reference-transcript``.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys

import numpy as np
import torch

# Reference README.md:431-438 "Results" table: NBDT top-1 of the released
# checkpoints (WRN-28-10 for CIFAR/TinyImagenet, EfficientNet-B7b ImageNet).
PUBLISHED_TOP1 = {
    "CIFAR10": 97.55,
    "CIFAR100": 82.97,
    "TinyImagenet200": 67.72,
    "Imagenet1000": 76.60,
}


def build_parser():
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--checkpoint", required=True,
                        help=".pth (reference format) or .msgpack checkpoint")
    parser.add_argument("--arch", required=True)
    parser.add_argument("--dataset", default="CIFAR10")
    parser.add_argument("--hierarchy", default=None,
                        help="default: induced-<arch>")
    parser.add_argument("--path-graph", default=None)
    parser.add_argument("--path-wnids", default=None)
    parser.add_argument("--val", choices=["real", "synthetic"], default="real",
                        help="'real' loads the staged dataset's val split; "
                        "'synthetic' validates the harness offline")
    parser.add_argument("--dataset-root", default="./data")
    parser.add_argument("--synthetic-size", type=int, default=512,
                        help="val images in --val synthetic mode")
    parser.add_argument("--synthetic-seed", type=int, default=0)
    parser.add_argument("--image-size", type=int, default=None,
                        help="synthetic image size (default: dataset's)")
    parser.add_argument("--batch-size", type=int, default=512)
    parser.add_argument("--expected-top1", type=float, default=None,
                        help="published NBDT top-1 to verify against "
                        "(default: the reference README table for the "
                        "dataset; pass explicitly for other recipes)")
    parser.add_argument("--tolerance", type=float, default=0.2,
                        help="allowed |measured - expected| in points "
                        "(reference README.md:438 grants ±0.1-0.2)")
    parser.add_argument("--transcript-n", type=int, default=16,
                        help="images to include in the decision transcript")
    parser.add_argument("--report-out", default=None,
                        help="write the full JSON report here")
    parser.add_argument("--reference-transcript", default=None,
                        help="transcript JSON to diff decision paths against")
    parser.add_argument("--device", default="cuda", help="torch device (default: cuda)")
    return parser


def _dataset_image_size(dataset: str) -> int:
    return {"CIFAR10": 32, "CIFAR100": 32, "TinyImagenet200": 64,
            "Imagenet1000": 224}.get(dataset, 32)


def _build_valset(args, num_classes):
    from ..data import get_dataset
    from ..data.cifar import LearnableSyntheticDataset
    from ..utils import DATASET_TO_CLASSES

    if args.val == "synthetic":
        size = args.image_size or _dataset_image_size(args.dataset)
        classes = DATASET_TO_CLASSES.get(args.dataset)
        return LearnableSyntheticDataset(
            num_classes=num_classes, size=args.synthetic_size,
            image_size=size, seed=args.synthetic_seed, train=False,
            classes=classes)
    ds_cls = get_dataset(args.dataset)
    try:
        return ds_cls(root=args.dataset_root, train=False)
    except FileNotFoundError as e:
        raise SystemExit(
            f"{e}\nNo staged {args.dataset} at {args.dataset_root}. Stage "
            "the dataset there, or run --val synthetic to validate the "
            "harness offline.")


@contextlib.contextmanager
def full_f32():
    """cuDNN convolutions and cuBLAS matmuls in full f32 (no TF32) for the
    block, the previous settings restored on exit."""
    prev = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = prev


@torch.no_grad()
def _evaluate(model, hard_rules, valset, batch_size):
    """Dual-report eval: backbone, NBDT-soft, and NBDT-hard top-1 from ONE
    backbone pass per batch (reference main.py:261-308 + the DecisionRules
    analyzer re-score, analysis.py:204-237). The hits are summed on the
    device, so the host transforms the next batch while the card runs this
    one; the last batch runs at its own size."""
    transform = valset.transform_val()
    n = len(valset)
    counts = torch.zeros(3, dtype=torch.int64, device=model.device)
    for start in range(0, n, batch_size):
        idx = np.arange(start, min(start + batch_size, n))
        imgs = np.stack([transform(valset.images[i]) for i in idx])
        labels = torch.as_tensor(valset.labels[idx], device=model.device)
        logits = model.model(model._input(imgs))
        soft = model.rules(logits)
        hard = hard_rules(logits)
        counts += torch.stack([(out.argmax(1) == labels).sum() for out in (logits, soft, hard)])
    return tuple(100.0 * c / n for c in counts.tolist())


def _transcript(model, valset, n):
    transform = valset.transform_val()
    n = min(n, len(valset))
    imgs = np.stack([transform(valset.images[i]) for i in range(n)])
    outputs, decisions = model.forward_with_decisions(imgs)
    preds = outputs.argmax(1).cpu().numpy()
    entries = []
    for i in range(n):
        entries.append({
            "index": i,
            "label": int(valset.labels[i]),
            "prediction": int(preds[i]),
            "predicted_class": model.tree.classes[int(preds[i])],
            "path": [
                {
                    "wnid": (d["node"].wnid if d.get("node") is not None
                             else None),
                    "name": d.get("name"),
                    "prob": float(d.get("prob", float("nan"))),
                    "entropy": float(d.get("entropy", float("nan"))),
                }
                for d in decisions[i]
            ],
        })
    return entries


def _diff_transcripts(ours, theirs):
    """Compare decision-path wnid sequences image-for-image."""
    mismatches = []
    for a, b in zip(ours, theirs):
        wa = [s["wnid"] for s in a["path"]]
        wb = [s["wnid"] for s in b["path"]]
        if wa != wb or a["prediction"] != b["prediction"]:
            mismatches.append(a["index"])
    return mismatches


def main(argv=None):
    args = build_parser().parse_args(argv)

    from ..model import SoftNBDT
    from ..models import get_model
    from ..rules import HardEmbeddedDecisionRules
    from ..utils import DATASET_TO_NUM_CLASSES, resolve_device

    device = resolve_device(args.device)
    num_classes = DATASET_TO_NUM_CLASSES[args.dataset]
    with device:  # the random init runs where the weights live; the checkpoint replaces it
        module = get_model(args.arch, num_classes)
    # TF32 off before the wrapper is built: it places the backbone in the
    # layout of f32 convs without TF32 (models/layout.py)
    with full_f32():
        # checkpoint -> converter -> weights, through the same public path the
        # wrappers' tests pin (NBDT(pretrained=True, checkpoint_path=)).
        model = SoftNBDT(
            dataset=args.dataset, model=module, arch=args.arch,
            hierarchy=args.hierarchy, path_graph=args.path_graph,
            path_wnids=args.path_wnids, pretrained=True,
            checkpoint_path=args.checkpoint, device=device,
        )
        hard_rules = HardEmbeddedDecisionRules(tree=model.tree, device=device)

        valset = _build_valset(args, num_classes)
        backbone_top1, soft_top1, hard_top1 = _evaluate(
            model, hard_rules, valset, args.batch_size)
        transcript = _transcript(model, valset, args.transcript_n)

    expected = args.expected_top1
    if expected is None and args.val == "real":
        expected = PUBLISHED_TOP1.get(args.dataset)

    report = {
        "checkpoint": args.checkpoint,
        "arch": args.arch,
        "dataset": args.dataset,
        "val": args.val,
        "n_val": len(valset),
        "backbone_top1": round(backbone_top1, 4),
        "nbdt_soft_top1": round(soft_top1, 4),
        "nbdt_hard_top1": round(hard_top1, 4),
        "expected_top1": expected,
        "tolerance": args.tolerance,
        "transcript": transcript,
    }

    checks = []
    if expected is not None:
        delta = soft_top1 - expected
        ok = abs(delta) <= args.tolerance
        checks.append(ok)
        report["top1_delta"] = round(delta, 4)
        print(f"top-1: measured (soft NBDT) {soft_top1:.2f} vs published "
              f"{expected:.2f} (delta {delta:+.2f}, tolerance "
              f"±{args.tolerance}) -> {'OK' if ok else 'MISMATCH'}")
    print(f"backbone top-1 {backbone_top1:.2f} | NBDT soft {soft_top1:.2f} "
          f"| NBDT hard {hard_top1:.2f}  ({len(valset)} images)")

    if args.reference_transcript:
        with open(args.reference_transcript) as f:
            ref = json.load(f)
        ref_entries = ref["transcript"] if isinstance(ref, dict) else ref
        mismatches = _diff_transcripts(transcript, ref_entries)
        ok = not mismatches
        checks.append(ok)
        report["transcript_mismatches"] = mismatches
        print(f"decision paths: {min(len(transcript), len(ref_entries))} "
              f"compared, {len(mismatches)} mismatched "
              f"-> {'OK' if ok else 'MISMATCH: ' + str(mismatches)}")

    report["pass"] = bool(all(checks)) if checks else None
    if args.report_out:
        with open(args.report_out, "w") as f:
            json.dump(report, f, indent=1)
        print(f"report written to {args.report_out}")

    if checks and not all(checks):
        print("FAIL")
        return 1
    print("PASS" if checks else
          "DONE (no expected value / reference transcript to verify "
          "against — report only)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
