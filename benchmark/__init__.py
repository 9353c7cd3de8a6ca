"""The benchmark of ``nbdt_torch`` on one NVIDIA H100 (see README.md)."""
