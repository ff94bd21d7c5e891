"""Training substrate: optimizer, loop, data pipeline, checkpointing."""
from .optimizer import AdamWConfig, AdamWState, adamw_init, adamw_update, cosine_schedule
from .loop import TrainConfig, Trainer, make_train_step
from .data import DataConfig, PrefetchIterator, make_batch_np, synthetic_batches
from .checkpoint import load_checkpoint, latest_step, save_checkpoint

__all__ = [
    "AdamWConfig", "AdamWState", "adamw_init", "adamw_update", "cosine_schedule",
    "TrainConfig", "Trainer", "make_train_step",
    "DataConfig", "PrefetchIterator", "make_batch_np", "synthetic_batches",
    "load_checkpoint", "latest_step", "save_checkpoint",
]
