"""Optimizer: AdamW over param trees, global-norm clipping, schedules,
microbatch gradient accumulation."""
from repro_torch.optim.accum import accumulate_grads
from repro_torch.optim.adamw import (adamw_init, adamw_update, apply_updates,
                                     clip_by_global_norm, global_norm,
                                     tree_leaves)
from repro_torch.optim.schedules import constant, warmup_cosine
