"""Step functions (port of the serving and prefill parts of
`repro.launch.steps`)."""
from __future__ import annotations

import torch

from ..configs.base import ArchConfig
from ..models import lm


def _check(cfg: ArchConfig, model: lm.LM, what: str) -> None:
    if model.cfg != cfg:
        raise ValueError(f"{what} step built for {cfg.name}, model is "
                         f"{model.cfg.name}")


def make_prefill_step(cfg: ArchConfig):
    def prefill_step(model: lm.LM, batch):
        """The whole prompt batch["tokens"] (B, S) in one forward; the
        logits (B, vocab_padded) of its last position."""
        _check(cfg, model, "prefill")
        x = lm._forward(model, cfg, batch["tokens"], extra=batch)
        return lm.logits_fn(model, cfg, x[:, -1:])[:, 0]
    return prefill_step


def make_serve_step(cfg: ArchConfig):
    def serve_step(model: lm.LM, state, batch):
        """One decode step for the whole request batch; greedy next token
        (int32, the first of equal maxima)."""
        _check(cfg, model, "serve")
        logits, state = lm.decode_step(model, state, batch["tokens"])
        next_tok = torch.argmax(logits, dim=-1).to(torch.int32)
        return next_tok, state
    return serve_step
