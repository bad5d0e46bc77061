"""Fine-tuning of the port (port of ``instsearch_tpu/train``): the trainer
and its losses, hard-negative mining and the epoch loop (``finetune``)."""
from .trainer import (
    TrainState, Trainer, contrastive_loss, smoothap_loss, triplet_loss,
)

__all__ = ["TrainState", "Trainer", "contrastive_loss", "smoothap_loss",
           "triplet_loss"]
