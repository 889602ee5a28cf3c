"""Snapshots in the reference's on-disk format (port of
``repro.checkpoint``)."""
from repro_torch.checkpoint.store import (AsyncSaveHandle, CheckpointStore,
                                         is_valid_step, latest_step,
                                         latest_valid_step, load_arrays,
                                         load_meta, restore,
                                         restore_resharded, save, valid_steps)

__all__ = ["AsyncSaveHandle", "CheckpointStore", "save", "restore",
           "restore_resharded", "latest_step", "latest_valid_step",
           "is_valid_step", "valid_steps", "load_arrays", "load_meta"]
