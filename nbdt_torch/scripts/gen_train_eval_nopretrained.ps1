# Pipeline for networks WITHOUT a pretrained checkpoint, on the PyTorch port
# (PowerShell equivalent of gen_train_eval_nopretrained.sh).

$model = "ResNet18"
$dataset = "CIFAR10"
$weight = 1

# 0. train the baseline neural network
python -m nbdt_torch.main --dataset=$dataset --arch=$model

# 1. generate hierarchy from the trained checkpoint
python -m nbdt_torch.bin.nbdt_hierarchy --dataset=$dataset --arch=$model --checkpoint=./checkpoint/ckpt-$dataset-$model.pth --force

# 2. train with soft tree supervision loss (from scratch)
python -m nbdt_torch.main --dataset=$dataset --arch=$model --hierarchy=induced-$model --loss=SoftTreeSupLoss --tree-supervision-weight=$weight

# 3. evaluate with soft then hard inference
foreach ($analysis in @("SoftEmbeddedDecisionRules", "HardEmbeddedDecisionRules")) {
  python -m nbdt_torch.main --dataset=$dataset --arch=$model --hierarchy=induced-$model --loss=SoftTreeSupLoss --eval --resume --analysis=$analysis --tree-supervision-weight=$weight
}
