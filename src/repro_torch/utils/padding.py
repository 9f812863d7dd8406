"""The pad-to-block-multiple helper, for numpy arrays and torch tensors."""
from __future__ import annotations

import numpy as np
import torch


def pad_to_multiple(a, axis: int, multiple: int):
    """Zero-pad ``a`` along ``axis`` up to the next multiple of ``multiple``.

    Returns ``(padded, pad)`` where ``pad`` is the number of zeros appended
    (0 when the size is already aligned — the input is returned unchanged).
    Tensors stay on their device; anything else goes through ``np.pad``.
    """
    pad = (-a.shape[axis]) % multiple
    if pad == 0:
        return a, 0
    if isinstance(a, torch.Tensor):
        shape = list(a.shape)
        shape[axis] = pad
        return torch.cat([a, a.new_zeros(shape)], dim=axis), pad
    widths = [(0, 0)] * a.ndim
    widths[axis] = (0, pad)
    return np.pad(a, widths), pad
