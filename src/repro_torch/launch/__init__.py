"""Step builders of the port (one device): the training step."""

from .steps import build_train_step, cast_for_compute, loss_and_grads

__all__ = ["build_train_step", "cast_for_compute", "loss_and_grads"]
