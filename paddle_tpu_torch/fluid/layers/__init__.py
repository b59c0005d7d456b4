"""Layers DSL, the slice the GPT, BERT, LeNet and ResNet programs use
(port of ``paddle_tpu/fluid/layers/``)."""

from . import control_flow, io, metric_op, nn, tensor  # noqa: F401
from .control_flow import *  # noqa: F401,F403
from .io import *  # noqa: F401,F403
from .metric_op import *  # noqa: F401,F403
from .nn import *  # noqa: F401,F403
from .tensor import *  # noqa: F401,F403
