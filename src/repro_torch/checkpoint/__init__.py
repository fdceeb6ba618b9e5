"""Verified, plan-aware checkpoints in the JAX package's format."""
from repro_torch.checkpoint.store import (CheckpointError, CheckpointManager,
                                          complete_steps, latest_step,
                                          read_manifest, restore_checkpoint,
                                          save_checkpoint, verify_step,
                                          wait_step_complete)

__all__ = ["CheckpointError", "CheckpointManager", "complete_steps",
           "latest_step", "read_manifest", "restore_checkpoint",
           "save_checkpoint", "verify_step", "wait_step_complete"]
