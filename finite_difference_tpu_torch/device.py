"""Device selection shared by the port's entry points."""
from __future__ import annotations

from typing import List

import numpy as np
import torch

DEFAULT_DEVICE = "cuda"


def resolve_device(device=DEFAULT_DEVICE) -> torch.device:
    """``torch.device`` for ``device``; raises when CUDA is asked for but absent.

    The port never moves work to the CPU on its own: a caller that wants the
    CPU (the tests, the plain reference) passes ``device="cpu"``.
    """
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but torch.cuda.is_available() is "
            "False; pass device='cpu' to run on the CPU"
        )
    return dev


def as_tensors(*xs, device=None) -> List[torch.Tensor]:
    """``xs`` as tensors on one device, for the elementwise closed forms.

    The device is ``device`` where one is given (resolved), else that of the
    first tensor among ``xs``, else the default (CUDA, which raises without
    a card). Tensors keep their dtype; numbers and numpy arrays become
    float64, booleans stay boolean.
    """
    dev = None if device is None else resolve_device(device)
    if dev is None:
        dev = next((x.device for x in xs if torch.is_tensor(x)), None)
    if dev is None:
        dev = resolve_device()
    out = []
    for x in xs:
        if torch.is_tensor(x):
            out.append(x.to(dev))
        else:
            a = np.asarray(x)
            out.append(torch.as_tensor(a if a.dtype == bool else a.astype(np.float64), device=dev))
    return out
