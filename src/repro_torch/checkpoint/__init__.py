from repro_torch.checkpoint.checkpointer import (Checkpointer,
                                                 CorruptCheckpointError)

__all__ = ["Checkpointer", "CorruptCheckpointError"]
