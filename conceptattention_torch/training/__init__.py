"""Training: the flow-matching step, the loop with checkpoint and resume,
and LoRA fine-tuning (`training/lora.py`)."""

from conceptattention_torch.training.train_loop import (
    TrainConfig,
    make_optimizer,
    train_loop,
)
from conceptattention_torch.training.train_step import (
    flow_matching_loss,
    init_train_state,
    make_train_step,
)

__all__ = [
    "flow_matching_loss", "make_train_step", "init_train_state",
    "TrainConfig", "make_optimizer", "train_loop",
]
