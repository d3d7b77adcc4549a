from repro_torch.optim.optimizers import (OptState, Optimizer, adafactor,
                                          adamw, clip_by_global_norm,
                                          cosine_schedule, for_config,
                                          global_norm)

__all__ = ["OptState", "Optimizer", "adafactor", "adamw",
           "clip_by_global_norm", "cosine_schedule", "for_config",
           "global_norm"]
