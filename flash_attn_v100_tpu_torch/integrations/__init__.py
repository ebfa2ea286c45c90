"""Ecosystem integrations of the PyTorch/CUDA port.

LoRA fine-tuning on the flagship model (`lora.py`: adapters on the
attention projections, gradients through `flash_attn_func`'s K1-K3, base
weights frozen), HF Llama / Mistral / Qwen2 checkpoint import
(`huggingface.py`), so real weights run through the training step and the
serving engine, and the torch-tensor entry points of the JAX package's
interop module (`torch_interop.py`), here thin names over the port's own
entry points.  Nothing here imports `transformers`: the converter takes an
HF model or a (state_dict, config) pair that the caller built.
"""
