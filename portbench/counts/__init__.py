"""The yardstick's arithmetic: the card's published peaks, a kernel's bytes
and operations, and a model step's useful FLOPs, all from shapes."""
