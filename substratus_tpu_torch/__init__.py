"""PyTorch/CUDA port of substratus_tpu's serving and training runtime, for
NVIDIA Hopper.

The module paths mirror the JAX package (``substratus_tpu``), which stays
the numerical reference: ``ops/``, ``models/``, ``serve/``, ``train/``
hold the same functions under the same names, written as PyTorch. Every
TPU kernel of the JAX package is hand-written CUDA for ``sm_90a`` under
``csrc/``, built at first use by ``kernels/`` and wrapped in ``ops/``
beside its plain PyTorch version.

This package imports ``torch`` and never ``jax``, and nothing of
``substratus_tpu``. Entry points run on ``cuda`` unless the caller asks
for ``device="cpu"``.
"""
