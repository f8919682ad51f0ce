from repro_torch.checkpoint.ckpt import (
    CheckpointCorruptError, load_carry, load_pytree, load_server_state,
    save_carry, save_pytree, save_server_state,
)

__all__ = ["CheckpointCorruptError", "load_carry", "load_pytree",
           "load_server_state", "save_carry", "save_pytree",
           "save_server_state"]
