"""Plain PyTorch reference of the benchmark: the models, the soft rules, the
training step and the work counts, independent of the program under test."""
