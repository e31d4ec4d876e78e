"""AdamW, global-norm clipping and learning-rate schedules."""

from .adamw import adamw_init, adamw_update, opt_state_specs
from .clip import clip_by_global_norm, global_norm
from .schedules import constant_lr, warmup_cosine

__all__ = ["adamw_init", "adamw_update", "opt_state_specs", "warmup_cosine", "constant_lr",
           "clip_by_global_norm", "global_norm"]
