"""PyTorch/CUDA port of substratus_tpu's serving runtime, for NVIDIA Hopper.

The module paths mirror the JAX package (``substratus_tpu``), which stays
the numerical reference: ``ops/``, ``models/``, ``serve/`` hold the same
functions under the same names, written as PyTorch. The two TPU kernels
on the serving path are hand-written CUDA for ``sm_90a`` under ``csrc/``,
built at first use by ``kernels/`` and wrapped in ``ops/flash_attention.py``
and ``ops/decode_attention.py`` beside their plain PyTorch versions.

This package imports ``torch`` and never ``jax``, and nothing of
``substratus_tpu``. Entry points run on ``cuda`` unless the caller asks
for ``device="cpu"``.
"""
