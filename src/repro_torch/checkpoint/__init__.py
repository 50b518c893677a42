from repro_torch.checkpoint.checkpoint import (  # noqa: F401
    CheckpointCorruptError, checkpoint_steps, latest_step,
    load_checkpoint, load_entry, save_checkpoint,
)
