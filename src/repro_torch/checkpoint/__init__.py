"""Atomic, step-indexed checkpoints of training state: the port's ``repro.checkpoint``."""
