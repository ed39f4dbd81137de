"""Logical-axis sharding rules over a torch ``DeviceMesh`` (see ``partition``)."""
