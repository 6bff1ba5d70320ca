"""Device selection: the GPU unless the caller asks for the CPU."""

from __future__ import annotations

import torch


def resolve_device(device='cuda'):
    """``torch.device(device)``; raises when CUDA is asked for and absent
    (entry points never fall back to the CPU on their own)."""
    device = torch.device(device)
    if device.type == 'cuda' and not torch.cuda.is_available():
        raise RuntimeError(
            'device %r requested but CUDA is not available; pass '
            "device='cpu' to run on the CPU" % str(device))
    return device
