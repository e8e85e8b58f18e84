"""Step functions (port of the train, prefill and serve steps of
`repro.launch.steps`; its sharding trees and jitted cells are XLA's and
have no counterpart on one device)."""
from __future__ import annotations

from typing import List

import torch

from ..configs.base import ArchConfig
from ..models import lm
from ..optim import make_optimizer, warmup_cosine


def _check(cfg: ArchConfig, model: lm.LM, what: str) -> None:
    if model.cfg != cfg:
        raise ValueError(f"{what} step built for {cfg.name}, model is "
                         f"{model.cfg.name}")


def _stacked(leaf: List[torch.Tensor]) -> torch.Tensor:
    """A JAX leaf (n_groups, ...) of the parameters it stacks: a view of
    the one parameter when n_groups is 1, else a copy."""
    return leaf[0].unsqueeze(0) if len(leaf) == 1 else torch.stack(leaf)


def make_train_step(cfg: ArchConfig, *, lr: float = 3e-4,
                    warmup: int = 100, total_steps: int = 10000):
    """(init_fn(model) -> optimizer state, train_step(model, opt_state,
    batch, step) -> (model, opt_state, {"loss", "grad_norm"})), as JAX's:
    the optimizer is cfg.optimizer on warmup_cosine(lr, warmup,
    total_steps), its state stacked per leaf of JAX's parameter tree
    (lm.param_leaves). init_fn also makes the model's parameters
    trainable. The step updates the model's parameters and the state in
    place; loss and grad_norm come back as 0-dim f32 tensors on the
    model's device."""
    init_opt, update_fn = make_optimizer(
        cfg.optimizer, warmup_cosine(lr, warmup, total_steps))

    def init_fn(model: lm.LM):
        _check(cfg, model, "train")
        lm.set_trainable(model)
        with torch.no_grad():
            return init_opt([_stacked(leaf)
                             for leaf in lm.param_leaves(model)])

    def train_step(model: lm.LM, opt_state, batch, step: int):
        """batch leaves have leading (accum, microbatch, ...). Each
        microbatch's loss and gradients (lm.loss_fn, autograd) are summed
        into f32 buffers stacked as the leaves (JAX sums g.astype(f32));
        their mean over the microbatches goes to the optimizer."""
        _check(cfg, model, "train")
        leaves = lm.param_leaves(model)
        flat = [p for leaf in leaves for p in leaf]
        accum = batch["tokens"].shape[0]
        gsum = [torch.zeros((len(leaf),) + tuple(leaf[0].shape),
                            dtype=torch.float32, device=leaf[0].device)
                for leaf in leaves]
        lsum = torch.zeros((), dtype=torch.float32,
                           device=model.embed.device)
        for i in range(accum):
            mb = {k: v[i] for k, v in batch.items()}
            with torch.enable_grad():
                loss = lm.loss_fn(model, cfg, mb)
                grads = iter(torch.autograd.grad(loss, flat,
                                                 allow_unused=True,
                                                 materialize_grads=True))
            for buf, leaf in zip(gsum, leaves):
                for g in range(len(leaf)):
                    buf[g].add_(next(grads))
            del grads
            lsum = lsum + loss.detach()
        for buf in gsum:
            buf.div_(accum)
        with torch.no_grad():
            params = [_stacked(leaf) for leaf in leaves]
            _, opt_state, gnorm = update_fn(gsum, opt_state, params, step)
            for leaf, p in zip(leaves, params):
                if len(leaf) > 1:
                    for g, w in enumerate(leaf):
                        w.copy_(p[g])
        return model, opt_state, {"loss": lsum / accum, "grad_norm": gnorm}

    return init_fn, train_step


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
