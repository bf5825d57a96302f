"""The model stack (counterpart of ``repro/models``): ten architectures
from one pattern-based transformer, in plain PyTorch."""
