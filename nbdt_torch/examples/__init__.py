"""Examples of the port, run as modules: ``python -m nbdt_torch.examples.train_seg``."""
