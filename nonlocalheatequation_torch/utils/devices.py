"""Device resolution for the port's entry points.

Every entry point takes a ``device`` (or the CLIs' ``--platform``) and runs
on the CUDA card unless the caller asks for the CPU.  There is no quiet
fallback: asking for the card on a host without one raises.
"""

from __future__ import annotations

import torch

#: CLI platform names -> torch device types
_PLATFORMS = {"gpu": "cuda", "cuda": "cuda", "cpu": "cpu"}


def resolve_device(spec=None) -> torch.device:
    """``None``/``"gpu"``/``"cuda"``/``"cuda:N"`` -> the CUDA card (raises if
    ``torch.cuda.is_available()`` is false); ``"cpu"`` -> the CPU.  A
    ``torch.device`` is checked the same way."""
    if spec is None:
        spec = "cuda"
    if isinstance(spec, str):
        spec = _PLATFORMS.get(spec, spec)
    dev = torch.device(spec)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "the CUDA device was requested (the default) but "
            "torch.cuda.is_available() is false; pass device='cpu' "
            "(--platform cpu) to run on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {spec!r}; use 'cuda' or 'cpu'")
    return dev


def resolve_dtype(dtype, device: torch.device) -> torch.dtype:
    """The state dtype, ``torch.float64`` or ``torch.float32``.  ``None``
    picks float64 on the CPU (the oracle contract's precision) and float32
    on the card (the headline configuration)."""
    if dtype is None:
        return torch.float64 if device.type == "cpu" else torch.float32
    if dtype not in (torch.float64, torch.float32):
        raise ValueError(f"state dtype must be torch.float64 or torch.float32, got {dtype!r}")
    return dtype
