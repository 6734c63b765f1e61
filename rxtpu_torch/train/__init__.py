from rxtpu_torch.train.checkpoint import (
    BestCheckpointer, checkpoint_exists, load_checkpoint, load_train_state, save_checkpoint,
)

__all__ = ["BestCheckpointer", "checkpoint_exists", "load_checkpoint", "load_train_state",
           "save_checkpoint"]
