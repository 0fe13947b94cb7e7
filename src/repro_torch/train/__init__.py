"""Training loop with fault tolerance and sync-free metrics."""
from repro_torch.train.trainer import MetricsRing, Trainer, TrainerConfig
