#!/usr/bin/env bash
# WordNet wnid + hierarchy generation on the PyTorch port (the counterpart
# of scripts/generate_hierarchies_wordnet.sh). Needs NLTK's WordNet corpus
# installed, or a mini-corpus (nbdt_torch.hierarchy.wnid.install_mini_corpus);
# the port downloads nothing, and nbdt_wnids falls back to FakeSynsets
# without a corpus.
set -euo pipefail

python -c "from nbdt_torch.hierarchy.wnid import maybe_install_wordnet; maybe_install_wordnet()"

# Generate WNIDs
for dataset in CIFAR10 CIFAR100; do
  python -m nbdt_torch.bin.nbdt_wnids --dataset="${dataset}"
done

# Generate and test hierarchies
for dataset in CIFAR10 CIFAR100 TinyImagenet200; do
  python -m nbdt_torch.bin.nbdt_hierarchy --dataset="${dataset}" --method=wordnet --force
done
