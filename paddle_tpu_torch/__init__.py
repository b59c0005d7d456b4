"""PyTorch/CUDA port of ``paddle_tpu`` for NVIDIA Hopper (H100).

The JAX package ``paddle_tpu`` stays the reference; this package grows
beside it slice by slice: GPT-2 served greedily by the continuous-batching
``DecodeEngine`` over the contiguous KV slot pool and over the paged pool
with speculative decoding; GPT-2 trained by
``models.gpt.build_gpt_lm_train`` (forward, backward, Adam), saved by
``fluid.io.save_inference_model``, loaded by
``inference.AnalysisPredictor`` and served by
``serving.InferenceServer``; and trained through the training runtime:
``fluid.DataLoader`` / ``PyReader`` and ``Executor.train_from_dataset``
with asynchronous ``checkpoint``s, preemption-safe resume, the training
guardian and the supervised launcher (``distributed``); and trained
data-parallel, one process a device, through
``fluid.CompiledProgram.with_data_parallel`` and the ``c_*`` collective
ops over ``torch.distributed`` (``parallel``). The Pallas
kernels those paths run (flash
forward with dropout, its two backward kernels, flash decode, paged
flash decode) are rewritten by hand in CUDA C++ for ``sm_90a``
(``csrc/``, built at first use by ``kernels/_build.py``).

The package imports ``torch`` and never ``jax`` or ``paddle_tpu``.
Entry points run on ``cuda`` unless the caller passes ``device="cpu"``;
on the CPU every kernel wrapper runs its plain PyTorch version.
"""

from . import fluid, inference, kernels, models, observability, serving
from . import checkpoint, distributed, parallel, reader  # noqa: F401
from .reader.decorator import batch  # noqa: F401  (paddle.batch)

__all__ = ["fluid", "inference", "kernels", "models", "observability",
           "serving", "checkpoint", "distributed", "parallel", "reader",
           "batch"]
