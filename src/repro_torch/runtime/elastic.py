"""Elastic re-scale (port of `repro.runtime.elastic`): move a training
state to another placement, and re-hash a data structure onto another
rank count.

Checkpoints store full (unsharded) leaves, so re-scaling a training state
is re-placement; on one device `reshard_tree` moves every leaf there.

The PGAS data structures re-scale by *re-insertion*: hash-table placement
depends on nranks, so `rehash_table` drains the old table (C_R phase) and
reinserts into a fresh one on the new rank count through the port's
`insert_rdma` (fused, as its default), with the same batched phases as
the JAX package.
"""
from __future__ import annotations

from typing import Any

from ..core import hashtable as ht_mod
from ..core.types import Promise
from .checkpoint import tree_flatten, tree_unflatten


def reshard_tree(tree: Any, device) -> Any:
    """Every leaf of `tree` (tensors) placed on `device`."""
    leaves, spec = tree_flatten(tree)
    return tree_unflatten(spec, [x.to(device) for x in leaves])


def rehash_table(old: ht_mod.DHashTable, new_nranks: int,
                 max_probes: int = 16) -> ht_mod.DHashTable:
    """Drain + reinsert under the new rank count (batched phases)."""
    P, L = old.win.data.shape
    rec_w, vw = old.rec_w, old.val_words
    recs = old.win.data.reshape(P, old.nslots, rec_w)
    flags = recs[..., 0] & 255
    live = flags == 2
    keys = recs[..., 1]
    vals = recs[..., 2:]
    new = ht_mod.make_hashtable(new_nranks, old.nslots * P // new_nranks
                                + max_probes, vw,
                                device=old.win.data.device)
    # Reinsert per old-rank batches; ranks beyond new_nranks fold onto
    # the new table via ownership hashing inside insert.
    k2 = keys.reshape(new_nranks, -1)
    v2 = vals.reshape(new_nranks, -1, vw)
    m2 = live.reshape(new_nranks, -1)
    new, ok, _ = ht_mod.insert_rdma(new, k2, v2, promise=Promise.CW,
                                    valid=m2, max_probes=max_probes)
    return new
