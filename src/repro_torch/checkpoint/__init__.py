"""npz checkpoints with async save and restore onto a device, in the
reference's format (either package restores the other's)."""

from repro_torch.checkpoint.ckpt import CheckpointManager, load_pytree, save_pytree

__all__ = ["CheckpointManager", "load_pytree", "save_pytree"]
