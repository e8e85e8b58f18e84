from .checkpoint import (AsyncCheckpointer, load_checkpoint,
                         restore_sharded, save_checkpoint)
from .straggler import StragglerMonitor
from .elastic import reshard_tree

__all__ = ["AsyncCheckpointer", "load_checkpoint", "restore_sharded",
           "save_checkpoint", "StragglerMonitor", "reshard_tree"]
