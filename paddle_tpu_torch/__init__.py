"""PyTorch/CUDA port of ``paddle_tpu`` for NVIDIA Hopper (H100).

The JAX package ``paddle_tpu`` stays the reference; this package grows
beside it slice by slice: GPT-2 served greedily by the continuous-batching
``DecodeEngine`` over the contiguous KV slot pool and over the paged pool
with speculative decoding, and GPT-2 trained by
``models.gpt.build_gpt_lm_train`` (forward, backward, Adam). The Pallas
kernels those paths run (flash forward with dropout, its two backward
kernels, flash decode, paged flash decode) are rewritten by hand in CUDA
C++ for ``sm_90a`` (``csrc/``, built at first use by
``kernels/_build.py``).

The package imports ``torch`` and never ``jax`` or ``paddle_tpu``.
Entry points run on ``cuda`` unless the caller passes ``device="cpu"``;
on the CPU every kernel wrapper runs its plain PyTorch version.
"""

from . import fluid, kernels, models, observability, serving

__all__ = ["fluid", "kernels", "models", "observability", "serving"]
