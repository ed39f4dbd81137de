"""Mamba S6 selective scan with an fp32 state."""
