"""Atomic, async checkpoints of the train path (:mod:`.manager`)."""
from .manager import (AsyncCheckpointer, apply_retention, available_steps,
                      latest_step, restore, save)

__all__ = ["AsyncCheckpointer", "save", "restore", "latest_step",
           "available_steps", "apply_retention"]
