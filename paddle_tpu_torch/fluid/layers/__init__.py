"""Layers DSL, the slice the GPT, BERT, LeNet, ResNet and Transformer NMT
programs use (port of ``paddle_tpu/fluid/layers/``). Importing it
patches ``Variable``'s operators (``math_op_patch``)."""

from . import math_op_patch  # noqa: F401  (patches Variable; first)
from . import control_flow, io, metric_op, nn, ops, tensor  # noqa: F401
from . import learning_rate_scheduler  # noqa: F401
from .tensor import *  # noqa: F401,F403
from .ops import *  # noqa: F401,F403
from .nn import *  # noqa: F401,F403
from .io import *  # noqa: F401,F403
from .control_flow import *  # noqa: F401,F403
from .metric_op import *  # noqa: F401,F403
from .learning_rate_scheduler import *  # noqa: F401,F403
