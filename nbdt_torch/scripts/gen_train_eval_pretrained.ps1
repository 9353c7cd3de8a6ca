# Pipeline for networks WITH a pretrained checkpoint, on the PyTorch port
# (PowerShell equivalent of gen_train_eval_pretrained.sh).

$model = "wrn28_10_cifar10"
$dataset = "CIFAR10"
$weight = 1

python -m nbdt_torch.bin.nbdt_hierarchy --dataset=$dataset --arch=$model --force

python -m nbdt_torch.main --lr=0.01 --dataset=$dataset --arch=$model --hierarchy=induced-$model --pretrained --loss=SoftTreeSupLoss --tree-supervision-weight=$weight

foreach ($analysis in @("SoftEmbeddedDecisionRules", "HardEmbeddedDecisionRules")) {
  python -m nbdt_torch.main --dataset=$dataset --arch=$model --hierarchy=induced-$model --loss=SoftTreeSupLoss --eval --resume --analysis=$analysis --tree-supervision-weight=$weight
}
