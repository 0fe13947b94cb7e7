"""Checkpointing: npz save/restore with atomic manifests (the JAX
package's ``checkpoint/``, in the port)."""
from repro_torch.checkpoint.io import (AsyncCheckpointer, latest_step,
                                       restore_checkpoint, save_checkpoint)
