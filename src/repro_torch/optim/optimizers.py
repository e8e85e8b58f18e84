"""Optimizers (port of `repro.optim.optimizers`): AdamW (f32 moments) and
Adafactor (factored second moment, beta1 = 0), the warm-up cosine
schedule and global-norm clipping.

The functions take flat lists of tensors, one per leaf of JAX's parameter
tree in its flatten order (`models.lm.param_leaves`,
`convert.lm_to_numpy`), each leaf stacked over n_groups as JAX stacks it:
Adafactor factors and normalizes a whole stacked leaf, so the stacking
changes its numbers. All update math runs in f32 whatever the parameter's
type, and the new value is cast back to it (round to nearest even, as
XLA's convert). Where JAX's functions return new trees, these write the
optimizer state, the clipped gradients and the parameters in place (one
copy of each in memory: the train step holds billions of f32 words) and
return them; they run under torch.no_grad.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, List, Tuple

import numpy as np
import torch

Tensor = torch.Tensor


def warmup_cosine(base_lr: float, warmup: int, total: int,
                  floor: float = 0.1) -> Callable[[int], float]:
    """step -> learning rate: linear warm-up to base_lr over `warmup`
    steps, then a cosine down to floor * base_lr at `total`. Computed in
    float32 as JAX's schedule (Python constants folded the same way) and
    returned as a Python float holding that f32 value."""
    f32 = np.float32

    def schedule(step: int) -> float:
        s = f32(step)
        warm = s / f32(max(warmup, 1))
        prog = np.clip((s - f32(warmup)) / f32(max(total - warmup, 1)),
                       f32(0.0), f32(1.0))
        cos = f32(floor) + f32((1 - floor) * 0.5) * (
            f32(1.0) + np.cos(f32(math.pi) * prog))
        return float(f32(base_lr) * (warm if s < warmup else cos))
    return schedule


@torch.no_grad()
def clip_by_global_norm(grads: List[Tensor], max_norm: float
                        ) -> Tuple[List[Tensor], Tensor]:
    """Scale every gradient by min(1, max_norm / ||grads||) in place; the
    norm is the f32 sum of squares summed leaf by leaf in the list's
    order. Returns (grads, the norm as a 0-dim f32 tensor)."""
    gn = torch.sqrt(sum(g.float().square().sum() for g in grads))
    scale = torch.clamp(max_norm / torch.clamp(gn, min=1e-12), max=1.0)
    for g in grads:
        g.mul_(scale)
    return grads, gn


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------
def adamw_init(params: List[Tensor]) -> Dict:
    """{"m", "v": f32 zeros like each leaf, "count": int32 0}."""
    return {"m": [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                  for p in params],
            "v": [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                  for p in params],
            "count": torch.zeros((), dtype=torch.int32,
                                 device=params[0].device)}


@torch.no_grad()
def adamw_update(grads: List[Tensor], state: Dict, params: List[Tensor],
                 lr: float, *, b1: float = 0.9, b2: float = 0.95,
                 eps: float = 1e-8, weight_decay: float = 0.1
                 ) -> Tuple[List[Tensor], Dict]:
    """One AdamW step with bias correction and decoupled weight decay,
    leaf by leaf: m = b1 m + (1 - b1) g, v = b2 v + (1 - b2) g g,
    p -= lr (m / (1 - b1^t) / (sqrt(v / (1 - b2^t)) + eps) + wd p).
    State and params are updated in place. Returns (params, state)."""
    count = state["count"] + 1
    cf = count.float()
    c1 = 1 - b1 ** cf
    c2 = 1 - b2 ** cf
    for g, m, v, p in zip(grads, state["m"], state["v"], params):
        g = g.float()
        m.mul_(b1).add_((1 - b1) * g)
        v.mul_(b2).add_((1 - b2) * g * g)
        step = m / c1
        step.div_((v / c2).sqrt_().add_(eps))
        pf = p.float()          # p itself when p is f32
        step.add_(weight_decay * pf).mul_(lr)
        p.copy_(pf.sub_(step))
    state["count"] = count
    return params, state


# ---------------------------------------------------------------------------
# Adafactor (Shazeer & Stern 2018), beta1 = 0, factored v for >= 2-D leaves
# ---------------------------------------------------------------------------
def adafactor_init(params: List[Tensor]) -> Dict:
    """{"slots": per leaf {"vr", "vc"} (row and column f32 means) for a
    leaf of >= 2 dims, else {"v"}; "count": int32 0}."""
    def one(p):
        z = dict(dtype=torch.float32, device=p.device)
        if p.dim() >= 2:
            return {"vr": torch.zeros(p.shape[:-1], **z),
                    "vc": torch.zeros(p.shape[:-2] + p.shape[-1:], **z)}
        return {"v": torch.zeros(p.shape, **z)}
    return {"slots": [one(p) for p in params],
            "count": torch.zeros((), dtype=torch.int32,
                                 device=params[0].device)}


@torch.no_grad()
def adafactor_update(grads: List[Tensor], state: Dict, params: List[Tensor],
                     lr: float, *, d: float = 1e-3, eps: float = 1e-30,
                     clip_thresh: float = 1.0, weight_decay: float = 0.0
                     ) -> Tuple[List[Tensor], Dict]:
    """One Adafactor step (beta2 = 1 - t^-0.8, update clipped to RMS
    clip_thresh, step size max(d, lr), weight decay lr * wd). Slots and
    params are updated in place. Returns (params, state)."""
    count = state["count"] + 1
    cf = count.float()
    beta2 = 1.0 - cf ** -0.8
    f32 = np.float32
    step_size = float(max(f32(d), f32(lr)))
    decay = float(f32(lr) * f32(weight_decay))
    for g, slot, p in zip(grads, state["slots"], params):
        g = g.float()
        g2 = g * g + eps
        if p.dim() >= 2:
            vr, vc = slot["vr"], slot["vc"]
            vr.mul_(beta2).add_((1 - beta2) * g2.mean(-1))
            vc.mul_(beta2).add_((1 - beta2) * g2.mean(-2))
            denom = torch.clamp(vr.mean(-1, keepdim=True), min=eps)
            vhat = (vr[..., None] / denom[..., None]) * vc[..., None, :]
        else:
            vhat = slot["v"].mul_(beta2).add_((1 - beta2) * g2)
        u = g / torch.sqrt(torch.clamp(vhat, min=eps))
        del vhat, g2
        rms_u = torch.sqrt((u * u).mean() + eps)
        u.div_(torch.clamp(rms_u / clip_thresh, min=1.0))
        pf = p.float()
        p.copy_(pf - step_size * u - decay * pf)
    state["count"] = count
    return params, state


# ---------------------------------------------------------------------------
# Front-end
# ---------------------------------------------------------------------------
def make_optimizer(kind: str, schedule, *, max_grad_norm: float = 1.0,
                   weight_decay: float = 0.1):
    """Returns (init_fn(params), update_fn(grads, state, params, step) ->
    (params, state, grad norm)): the gradients clipped to max_grad_norm,
    then one step of `kind` at schedule(step)."""
    if kind == "adamw":
        def update(grads, state, params, step):
            grads, gn = clip_by_global_norm(grads, max_grad_norm)
            p2, s2 = adamw_update(grads, state, params, schedule(step),
                                  weight_decay=weight_decay)
            return p2, s2, gn
        return adamw_init, update
    if kind == "adafactor":
        def update(grads, state, params, step):
            grads, gn = clip_by_global_norm(grads, max_grad_norm)
            p2, s2 = adafactor_update(grads, state, params, schedule(step),
                                      weight_decay=weight_decay)
            return p2, s2, gn
        return adafactor_init, update
    raise ValueError(kind)
