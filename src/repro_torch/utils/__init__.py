"""Small shared utilities."""
from repro_torch.utils.device import resolve_device
from repro_torch.utils.padding import pad_to_multiple

__all__ = ["pad_to_multiple", "resolve_device"]
