"""Decoder (attention and xLSTM layers) and paged cache on torch tensors."""
from repro_torch.models.model import Model  # noqa: F401
