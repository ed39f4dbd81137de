"""Optimizers and the training loop: the port's ``repro.training``."""
