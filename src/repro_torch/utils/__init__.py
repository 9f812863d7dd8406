"""Small shared utilities."""
from repro_torch.utils.padding import pad_to_multiple

__all__ = ["pad_to_multiple"]
