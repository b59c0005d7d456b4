"""Trainer descriptors (reference: python/paddle/fluid/trainer_desc.py —
TrainerDesc:20 / MultiTrainer:132 / DistMultiTrainer:153 /
PipelineTrainer:172). In this framework the desc and the runtime trainer
are ONE object (fluid/trainer.py): the reference split desc-building
(protobuf) from C++ execution, while here the Python trainer executes
directly, so these are the same classes under the reference's module
spelling.

Port of ``paddle_tpu/fluid/trainer_desc.py``."""

from .trainer import (  # noqa: F401
    TrainerBase as TrainerDesc,
    MultiTrainer,
    DistMultiTrainer,
    PipelineTrainer,
)

__all__ = ["TrainerDesc", "MultiTrainer", "DistMultiTrainer",
           "PipelineTrainer"]
