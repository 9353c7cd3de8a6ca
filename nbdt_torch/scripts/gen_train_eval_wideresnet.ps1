# WRN-28-10 pipeline over CIFAR10/CIFAR100/TinyImagenet200 on the PyTorch
# port (PowerShell equivalent of gen_train_eval_wideresnet.sh).

$SPECS = @("CIFAR10 wrn28_10_cifar10 1", "CIFAR100 wrn28_10_cifar100 1", "TinyImagenet200 wrn28_10 10")

foreach ($spec in $SPECS) {
  $params = $spec.split(" ")
  $dataset = $params[0]
  $model = $params[1]
  $weight = $params[2]

  python -m nbdt_torch.bin.nbdt_hierarchy --dataset=$dataset --arch=$model --force

  python -m nbdt_torch.main --lr=0.01 --dataset=$dataset --arch=$model --hierarchy=induced-$model --pretrained --loss=SoftTreeSupLoss --tree-supervision-weight=$weight

  foreach ($analysis in @("SoftEmbeddedDecisionRules", "HardEmbeddedDecisionRules")) {
    python -m nbdt_torch.main --dataset=$dataset --arch=$model --hierarchy=induced-$model --loss=SoftTreeSupLoss --eval --resume --analysis=$analysis --tree-supervision-weight=$weight
  }
}
