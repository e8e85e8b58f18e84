from .optimizers import (adafactor_init, adafactor_update, adamw_init,
                         adamw_update, clip_by_global_norm, make_optimizer,
                         warmup_cosine)
from .compression import (compress_int8, compressed_mean_grads,
                          decompress_int8)

__all__ = ["adafactor_init", "adafactor_update", "adamw_init",
           "adamw_update", "clip_by_global_norm", "compress_int8",
           "compressed_mean_grads", "decompress_int8", "make_optimizer",
           "warmup_cosine"]
