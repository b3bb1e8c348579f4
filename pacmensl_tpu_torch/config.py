"""Global configuration for pacmensl_tpu_torch.

The reference library (pacmensl) is double precision throughout, and an
NVIDIA Hopper card has native FP64, so float64 is the default dtype on
CUDA and on the CPU alike.  There is no device auto-selection: every
solver object takes an explicit ``device`` (default ``"cuda"``), and asking
for CUDA on a host without it raises.

TF32 stays off for the same reason the JAX package forces exact f32
matmuls (``pacmensl_tpu/config.py``): rounding noise in probability
transport shows up as mass at far states whose sink flux then drives
runaway FSP expansion.
"""
from __future__ import annotations

import torch

from .sys.errors import SetupError

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

#: Default floating point dtype for probability vectors and operators.
DEFAULT_DTYPE = torch.float64


def resolve_device(device="cuda") -> torch.device:
    """``torch.device`` for ``device``; raises when CUDA is asked for on a
    host without it (no silent CPU fallback)."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise SetupError(
                f"device {device!r} requested but torch.cuda.is_available() "
                "is False; pass device='cpu' to run on the host")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise SetupError(f"unsupported device {device!r} (cuda or cpu)")
    return dev
