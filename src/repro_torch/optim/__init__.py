"""The optimizer of the train path: AdamW with a cosine schedule and
global-norm clipping (:mod:`.adamw`)."""
from . import adamw
from .adamw import AdamWConfig, AdamWState, global_norm, init, schedule, update

__all__ = ["adamw", "AdamWConfig", "AdamWState", "init", "update",
           "schedule", "global_norm"]
