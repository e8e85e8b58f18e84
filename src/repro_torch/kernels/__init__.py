# Hand-written Hopper kernels of the data structures and the model
# (csrc/*.cu, bound with ctypes), their plain PyTorch versions (ref.py) and
# the device dispatch (ops.py):
#   amo_apply / fused_apply — serialized AMO batch at the owner (the NIC lane)
#   txn_group_apply — the transactional owner lane (all-or-nothing groups)
#   hash_find / hash_insert — open-addressing probe loops (AM handler bodies)
#   flash_attention — causal / local-window GQA attention (prefill, train)
#   flash_attention_bwd — its backward (dq, dk, dv; train)
#   flash_decode — one-token GQA decode attention over the serving KV cache
#   moe_dispatch — expert histogram + stable positions (batched FAA ticket)
#   rg_lru_scan, rg_lru_scan_bwd — the RG-LRU block's gated linear
#     recurrence and its backward
#   mlstm_chunkwise, mlstm_step, slstm_scan — the xLSTM cells (the mLSTM
#     over a sequence and one step, the sLSTM recurrence), and their
#     backwards mlstm_chunkwise_bwd, mlstm_step_bwd, slstm_scan_bwd
from . import ops, ref

__all__ = ["ops", "ref"]
