"""Staggered-cohort offload decisions over epochs (the cluster's decide step)."""
