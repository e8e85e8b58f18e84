"""Deterministic synthetic data pipeline fed through the paper's DQueue
(port of `repro.data.pipeline`).

Determinism contract: batch(step, host) is a pure function of
(seed, step, host), made with numpy exactly as the JAX package makes it
(bit for bit), so elastic restarts and replayed steps are exact.

The producer/consumer hand-off uses the port's DQueue at the paper's
phasal promise levels: the producer pushes work descriptors under C_W, a
barrier (the end of the step) separates phases, and consumers pop under
C_R.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict

import numpy as np
import torch

from ..configs.base import ArchConfig, ShapeSpec
from ..core import queue as dqueue
from ..core.types import Promise


@dataclass
class SyntheticLM:
    """Markov-ish synthetic LM data: learnable (low-entropy) but
    non-trivial. tokens[t+1] = (a * tokens[t] + drift + noise) % vocab with
    a per-sequence drift."""

    vocab: int
    seq_len: int
    seed: int = 0

    def batch(self, step: int, host: int, batch_size: int) -> np.ndarray:
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed, step, host]))
        B, S = batch_size, self.seq_len
        a = 3
        drift = rng.integers(0, 7, (B, 1))
        t0 = rng.integers(0, self.vocab, (B, 1))
        toks = np.zeros((B, S), np.int64)
        toks[:, :1] = t0
        noise = (rng.random((B, S)) < 0.05) * rng.integers(
            0, self.vocab, (B, S))
        for t in range(1, S):
            toks[:, t] = (a * toks[:, t - 1] + drift[:, 0]) % self.vocab
        toks = np.where(noise > 0, noise, toks)
        return toks.astype(np.int32)

    def train_batch(self, cfg: ArchConfig, shape: ShapeSpec, step: int,
                    host: int = 0, device="cuda") -> Dict[str, torch.Tensor]:
        """{"tokens": (grad_accum, global_batch / grad_accum, seq_len)
        int32} on `device` (and the encdec / vlm front-end inputs, in the
        compute dtype, as JAX's)."""
        B = shape.global_batch
        A = shape.grad_accum
        toks = self.batch(step, host, B).reshape(A, B // A, shape.seq_len)
        out = {"tokens": torch.as_tensor(toks, device=device)}
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed, step, host, 7]))
        if cfg.family == "encdec":
            out["frames"] = torch.as_tensor(rng.normal(
                0, 1, (A, B // A, shape.seq_len, cfg.d_model)),
                dtype=cfg.compute_dtype, device=device)
        if cfg.family == "vlm":
            st = shape.seq_len - cfg.n_patch_tokens
            out["tokens"] = out["tokens"][..., :st]
            out["patch_embeds"] = torch.as_tensor(rng.normal(
                0, 1, (A, B // A, cfg.n_patch_tokens, cfg.d_model)),
                dtype=cfg.compute_dtype, device=device)
        return out


class QueuedPipeline:
    """Producer/consumer over a DQueue of work descriptors
    [step | host | shard]. Phasal promises per the paper: pushes (C_W) and
    pops (C_R) are separated by the step barrier."""

    def __init__(self, nranks: int, host: int = 0, capacity: int = 1024,
                 device="cuda"):
        self.q = dqueue.make_queue(nranks, host=host, capacity=capacity,
                                   val_words=3, device=device)
        self.nranks = nranks
        self.device = device

    def produce(self, steps, hosts_per_step: int):
        """Push descriptors for a window of steps (one producer rank)."""
        descs = np.array([[s, h, s * hosts_per_step + h]
                          for s in steps for h in range(hosts_per_step)],
                         np.int32)
        P = self.nranks
        per = -(-len(descs) // P)
        pad = np.zeros((per * P - len(descs), 3), np.int32)
        vals = torch.as_tensor(np.concatenate([descs, pad]).reshape(
            P, per, 3), device=self.device)
        valid = torch.as_tensor(
            np.arange(per * P).reshape(P, per) < len(descs),
            device=self.device)
        self.q, ok = dqueue.push(self.q, vals, promise=Promise.CW,
                                 valid=valid)
        return ok

    def consume(self, n_per_rank: int):
        """Pop up to n descriptors per rank (C_R phase)."""
        self.q, got, vals = dqueue.pop(self.q, n_per_rank,
                                       promise=Promise.CR)
        return got, vals
