# WordNet wnid + hierarchy generation on the PyTorch port (PowerShell
# equivalent of generate_hierarchies_wordnet.sh).

python -c "from nbdt_torch.hierarchy.wnid import maybe_install_wordnet; maybe_install_wordnet()"

foreach ($dataset in @("CIFAR10", "CIFAR100")) {
  python -m nbdt_torch.bin.nbdt_wnids --dataset=$dataset
}

foreach ($dataset in @("CIFAR10", "CIFAR100", "TinyImagenet200")) {
  python -m nbdt_torch.bin.nbdt_hierarchy --dataset=$dataset --method=wordnet --force
}
