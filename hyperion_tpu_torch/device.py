"""Device and dtype policy of the port (counterpart of
``hyperion_tpu/model/run.py:_engine_dtype``).

The engine computes in float32 on a CUDA card and in float64 on the CPU,
where the parity tests hold it against the JAX package running in x64."""

import torch


def resolve_device(device=None):
    """The torch device to run on: ``None`` means the card. The CPU runs
    only when the caller asks for it with ``'cpu'``; asking for the card
    where there is none raises."""
    device = torch.device('cuda' if device is None else device)
    if device.type == 'cuda' and not torch.cuda.is_available():
        raise RuntimeError("device='cuda' (the default) needs a CUDA card, "
                           "and torch.cuda.is_available() is False: pass "
                           "device='cpu' to run on the CPU")
    if device.type not in ('cuda', 'cpu'):
        raise ValueError("unsupported device %s (use 'cuda' or 'cpu')"
                         % device)
    return device


def engine_dtype(device, dtype=None):
    """float32 on CUDA, float64 on the CPU, unless ``dtype`` is given."""
    if dtype is not None:
        return dtype
    return torch.float32 if device.type == 'cuda' else torch.float64
