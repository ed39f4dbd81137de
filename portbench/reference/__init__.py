"""The plain fp32 reference of the served models: its own weights, drawn
from the seed by a frozen copy of the program's per-leaf rule, and a forward
pass in plain PyTorch with TF32 off. It imports nothing of the program."""
