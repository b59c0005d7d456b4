"""TrainerFactory (reference: python/paddle/fluid/trainer_factory.py:26)
under its own module spelling; the implementation lives with the
trainers (fluid/trainer.py).

Port of ``paddle_tpu/fluid/trainer_factory.py``."""

from .trainer import TrainerFactory  # noqa: F401

__all__ = ["TrainerFactory"]
