#!/usr/bin/env bash
# WRN-28-10 pipeline over CIFAR10/CIFAR100/TinyImagenet200 on the PyTorch
# port (the counterpart of scripts/gen_train_eval_wideresnet.sh): induce the
# hierarchy from the pretrained classifier, fine-tune with soft tree
# supervision, evaluate with soft and hard NBDT inference. Want the WordNet
# hierarchy instead? Set --hierarchy=wordnet below.
set -euo pipefail

ARCH="wrn28_10"
for spec in "CIFAR10 ${ARCH}_cifar10 1" "CIFAR100 ${ARCH}_cifar100 1" "TinyImagenet200 ${ARCH} 10"; do
  read -r dataset model weight <<< "${spec}"

  # 1. generate hierarchy from the model's classifier weights
  python -m nbdt_torch.bin.nbdt_hierarchy --dataset="${dataset}" --arch="${model}" --force

  # 2. fine-tune with soft tree supervision
  python -m nbdt_torch.main --lr=0.01 --dataset="${dataset}" --arch="${model}" \
    --hierarchy="induced-${model}" --pretrained --loss=SoftTreeSupLoss \
    --tree-supervision-weight="${weight}"

  # 3. evaluate with soft then hard inference
  for analysis in SoftEmbeddedDecisionRules HardEmbeddedDecisionRules; do
    python -m nbdt_torch.main --dataset="${dataset}" --arch="${model}" \
      --hierarchy="induced-${model}" --loss=SoftTreeSupLoss --eval --resume \
      --analysis="${analysis}" --tree-supervision-weight="${weight}"
  done
done
