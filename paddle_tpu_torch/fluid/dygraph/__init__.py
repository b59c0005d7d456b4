"""Dygraph (eager) mode (port of ``paddle_tpu/fluid/dygraph/``; reference:
the paddle/fluid/imperative/ C++ engine and python/paddle/fluid/dygraph/).

A ``VarBase`` wraps a torch tensor on the guard's device; the ``Tracer``
runs each op's lowering at once, through the registry the Executor uses
(as the reference's dygraph reuses the kernel registry through
PreparedOp, imperative/prepared_operator.h:31), and records what the
backward needs (``tracer.py``)."""

from . import base
from .base import (  # noqa: F401
    guard,
    enabled,
    enable_dygraph,
    disable_dygraph,
    to_variable,
    no_grad,
    grad,
)
from .layers import Layer  # noqa: F401
from .nn import (  # noqa: F401
    Conv3D,
    Conv2DTranspose,
    Conv3DTranspose,
    GRUUnit,
    NCE,
    BilinearTensorProduct,
    SequenceConv,
    RowConv,
    TreeConv,
    Conv2D,
    Pool2D,
    Linear,
    FC,
    BatchNorm,
    Embedding,
    LayerNorm,
    Dropout,
    PRelu,
    GroupNorm,
    SpectralNorm,
)
from .tracer import Tracer, VarBase  # noqa: F401
from .container import Sequential  # noqa: F401
from .backward_strategy import BackwardStrategy  # noqa: F401
from .parallel import DataParallel, ParallelEnv, prepare_context  # noqa: F401
from .checkpoint import save_dygraph, load_dygraph  # noqa: F401
from .learning_rate_scheduler import (  # noqa: F401
    NoamDecay,
    PiecewiseDecay,
    NaturalExpDecay,
    ExponentialDecay,
    InverseTimeDecay,
    PolynomialDecay,
    CosineDecay,
)
from . import jit  # noqa: F401
from .jit import TracedLayer  # noqa: F401
