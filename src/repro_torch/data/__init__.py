"""The train path's synthetic data (:mod:`.pipeline`)."""
from .pipeline import DataConfig, DataIterator, batch_for_step

__all__ = ["DataConfig", "DataIterator", "batch_for_step"]
