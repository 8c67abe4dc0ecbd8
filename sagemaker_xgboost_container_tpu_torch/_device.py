"""Device choice for the port's entry points."""

import torch

from .toolkit import exceptions as exc


def resolve_device(device=None):
    """The torch device an entry point runs on: CUDA unless the caller names
    another. Raises when CUDA is asked for (explicitly or by default) and no
    GPU is present; there is no silent CPU fallback."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise exc.UserError(
            "device {!r} requested but no CUDA device is available; pass "
            "device='cpu' to run on the CPU".format(str(dev))
        )
    return dev
