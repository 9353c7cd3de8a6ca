#!/usr/bin/env bash
# ResNet18 pipeline on the PyTorch port (the counterpart of
# scripts/gen_train_eval_resnet.sh): train from scratch with soft tree
# supervision, then evaluate soft + hard.
set -euo pipefail

ARCH="ResNet18"
for spec in "CIFAR10 1" "CIFAR100 1" "TinyImagenet200 10"; do
  read -r dataset weight <<< "${spec}"

  python -m nbdt_torch.bin.nbdt_hierarchy --dataset="${dataset}" --arch="${ARCH}" --force

  python -m nbdt_torch.main --lr=0.1 --dataset="${dataset}" --arch="${ARCH}" \
    --hierarchy="induced-${ARCH}" --loss=SoftTreeSupLoss \
    --tree-supervision-weight="${weight}"

  for analysis in SoftEmbeddedDecisionRules HardEmbeddedDecisionRules; do
    python -m nbdt_torch.main --dataset="${dataset}" --arch="${ARCH}" \
      --hierarchy="induced-${ARCH}" --loss=SoftTreeSupLoss --eval --resume \
      --analysis="${analysis}" --tree-supervision-weight="${weight}"
  done
done
