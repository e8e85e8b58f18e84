# The model zoo's serving and prefill paths (port of `repro.models`):
# decoder-only models of attention, local-attention, RG-LRU, MLP and MoE
# blocks, decoded token by token or run over a whole prompt.
from . import lm

__all__ = ["lm"]
