"""Dense decoder and paged KV cache on torch tensors."""
from repro_torch.models.model import Model  # noqa: F401
