from repro_torch.optim.adamw import (AdamWConfig, adamw_init, adamw_update,
                                     clip_by_global_norm, cosine_schedule,
                                     global_norm, int8_adamw_init,
                                     int8_adamw_update)

__all__ = ["AdamWConfig", "adamw_init", "adamw_update",
           "clip_by_global_norm", "cosine_schedule", "global_norm",
           "int8_adamw_init", "int8_adamw_update"]
