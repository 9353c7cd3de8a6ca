#!/usr/bin/env bash
# Pipeline for networks WITH a pretrained checkpoint, on the PyTorch port
# (the counterpart of scripts/gen_train_eval_pretrained.sh). Want the
# WordNet hierarchy instead? Set --hierarchy=wordnet below.
set -euo pipefail

model=wrn28_10_cifar10
dataset=CIFAR10
weight=1

# 1. generate hierarchy from the pretrained classifier weights
python -m nbdt_torch.bin.nbdt_hierarchy --dataset="${dataset}" --arch="${model}" --force

# 2. fine-tune with soft tree supervision loss
python -m nbdt_torch.main --lr=0.01 --dataset="${dataset}" --arch="${model}" \
  --hierarchy="induced-${model}" --pretrained --loss=SoftTreeSupLoss \
  --tree-supervision-weight="${weight}"

# 3. evaluate with soft then hard inference
for analysis in SoftEmbeddedDecisionRules HardEmbeddedDecisionRules; do
  python -m nbdt_torch.main --dataset="${dataset}" --arch="${model}" \
    --hierarchy="induced-${model}" --loss=SoftTreeSupLoss --eval --resume \
    --analysis="${analysis}" --tree-supervision-weight="${weight}"
done
