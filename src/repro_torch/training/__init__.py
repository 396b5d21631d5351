from .checkpoint import CheckpointManager
from .optimizer import AdamWConfig, adamw_update, opt_state_specs
from .train_loop import Trainer, inject_failure_at

__all__ = ["CheckpointManager", "AdamWConfig", "adamw_update",
           "opt_state_specs", "Trainer", "inject_failure_at"]
