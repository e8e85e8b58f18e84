# The model zoo's serving, prefill and training paths (port of
# `repro.models`): decoder-only models of attention, local-attention,
# RG-LRU, MLP and MoE blocks, decoded token by token, run over a whole
# prompt, or trained through loss_fn and its gradients.
from . import lm

__all__ = ["lm"]
