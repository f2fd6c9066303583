"""PyTorch + CUDA port of ``scene_generation_tpu`` (scene graph -> image).

The JAX package beside it is the reference; this package imports none of
it. Entry points run on the CUDA device unless the caller passes
``device="cpu"``; with no GPU and no explicit request they raise.
"""
from __future__ import annotations

from typing import Optional, Union

import torch

__all__ = ["resolve_device"]


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless asked otherwise.

    Raises when no device is given and no CUDA device exists, so that a
    missing GPU never turns into a silent CPU run.
    """
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the plain "
            "PyTorch versions of the kernels on the CPU")
    return torch.device("cuda")
