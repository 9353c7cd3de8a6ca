#!/usr/bin/env bash
# Pipeline for networks WITHOUT a pretrained checkpoint, on the PyTorch port
# (the counterpart of scripts/gen_train_eval_nopretrained.sh): train the
# baseline first, induce the hierarchy from its checkpoint, then train with
# tree supervision from scratch. Runs on the CUDA card (the CLIs' default).
set -euo pipefail

model=ResNet18
dataset=CIFAR10
weight=1

# 0. train the baseline neural network
python -m nbdt_torch.main --dataset="${dataset}" --arch="${model}"

# 1. generate hierarchy from the trained checkpoint (the port's trainer
#    writes a .pth where the JAX package's writes a .msgpack)
python -m nbdt_torch.bin.nbdt_hierarchy --dataset="${dataset}" --arch="${model}" --force \
  --checkpoint="./checkpoint/ckpt-${dataset}-${model}.pth"

# 2. train with soft tree supervision loss (from scratch; add
#    --path-resume=./checkpoint/ckpt-${dataset}-${model}.pth --lr=0.01
#    to fine-tune instead)
python -m nbdt_torch.main --dataset="${dataset}" --arch="${model}" \
  --hierarchy="induced-${model}" --loss=SoftTreeSupLoss \
  --tree-supervision-weight="${weight}"

# 3. evaluate with soft then hard inference
for analysis in SoftEmbeddedDecisionRules HardEmbeddedDecisionRules; do
  python -m nbdt_torch.main --dataset="${dataset}" --arch="${model}" \
    --hierarchy="induced-${model}" --loss=SoftTreeSupLoss --eval --resume \
    --analysis="${analysis}" --tree-supervision-weight="${weight}"
done
