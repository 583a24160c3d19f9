"""PyTorch port of the CoEdge-RAG serving path for NVIDIA Hopper GPUs.

Module for module it mirrors the JAX package ``repro`` (the reference),
but imports nothing of it: configs, tokenizer, corpus and encoder are
copies, the model and serving stack are rewritten on ``torch`` tensors,
and the TPU Pallas kernels are replaced by hand-written CUDA C++ kernels
in ``repro_torch.kernels`` (each beside a plain PyTorch version).

Entry points take ``device=`` and default to ``"cuda"``; only a caller
that passes ``device="cpu"`` runs on the CPU, where every kernel wrapper
uses its plain version.
"""
from repro_torch.device import resolve_device  # noqa: F401
