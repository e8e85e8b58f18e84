# Hand-written Hopper kernels for the owner lanes and RPC handler bodies
# (csrc/*.cu, bound with ctypes), their plain PyTorch versions (ref.py) and
# the device dispatch (ops.py):
#   amo_apply / fused_apply — serialized AMO batch at the owner (the NIC lane)
#   hash_find / hash_insert — open-addressing probe loops (AM handler bodies)
from . import ops, ref

__all__ = ["ops", "ref"]
