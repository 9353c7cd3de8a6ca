"""Command-line tools: ``python -m nbdt_torch.bin.nbdt_hierarchy`` and
``python -m nbdt_torch.bin.nbdt_wnids``."""
