# The model zoo's serving path (port of `repro.models`): decoder-only models
# of attention, MLP and MoE blocks, decoded token by token.
from . import lm

__all__ = ["lm"]
