from .optimizers import (adafactor_init, adafactor_update, adamw_init,
                         adamw_update, clip_by_global_norm, make_optimizer,
                         warmup_cosine)

__all__ = ["adafactor_init", "adafactor_update", "adamw_init",
           "adamw_update", "clip_by_global_norm", "make_optimizer",
           "warmup_cosine"]
