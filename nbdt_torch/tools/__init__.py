"""Probe entry points of the port (``python -m nbdt_torch.tools.<name>``)."""
