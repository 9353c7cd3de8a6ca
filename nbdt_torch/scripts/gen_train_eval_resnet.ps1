# ResNet18 pipeline over CIFAR10/CIFAR100/TinyImagenet200 on the PyTorch
# port (PowerShell equivalent of gen_train_eval_resnet.sh).

$SPECS = @("CIFAR10 1", "CIFAR100 1", "TinyImagenet200 10")
$model = "ResNet18"

foreach ($spec in $SPECS) {
  $params = $spec.split(" ")
  $dataset = $params[0]
  $weight = $params[1]

  # 1. generate hierarchy
  python -m nbdt_torch.bin.nbdt_hierarchy --dataset=$dataset --arch=$model --force

  # 2. train with soft tree supervision loss
  python -m nbdt_torch.main --lr=0.1 --dataset=$dataset --arch=$model --hierarchy=induced-$model --loss=SoftTreeSupLoss --tree-supervision-weight=$weight

  # 3. evaluate with soft then hard inference
  foreach ($analysis in @("SoftEmbeddedDecisionRules", "HardEmbeddedDecisionRules")) {
    python -m nbdt_torch.main --dataset=$dataset --arch=$model --hierarchy=induced-$model --loss=SoftTreeSupLoss --eval --resume --analysis=$analysis --tree-supervision-weight=$weight
  }
}
