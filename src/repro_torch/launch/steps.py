"""Step functions (port of the serving part of `repro.launch.steps`)."""
from __future__ import annotations

import torch

from ..configs.base import ArchConfig
from ..models import lm


def make_serve_step(cfg: ArchConfig):
    def serve_step(model: lm.LM, state, batch):
        """One decode step for the whole request batch; greedy next token
        (int32, the first of equal maxima)."""
        if model.cfg != cfg:
            raise ValueError(f"serve step built for {cfg.name}, model is "
                             f"{model.cfg.name}")
        logits, state = lm.decode_step(model, state, batch["tokens"])
        next_tok = torch.argmax(logits, dim=-1).to(torch.int32)
        return next_tok, state
    return serve_step
