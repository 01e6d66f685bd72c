"""Training (port of substratus_tpu/train/): the one-card trainer, full or
LoRA finetuning, through the flash kernels' backward (ops/flash_attention.py)."""
