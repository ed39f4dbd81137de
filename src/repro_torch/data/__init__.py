"""The synthetic, seeded training data: the port's ``repro.data``."""
