"""Checkpoint loading (port of substratus_tpu/load/): llama.cpp GGUF files
(load/gguf.py) and local HuggingFace directories of safetensors or torch
``.bin`` files (load/hf.py), streamed tensor by tensor into a ``Llama`` on
its device. No module here imports ``transformers`` or ``safetensors``:
the card's machine has neither, and every format is read by hand."""
