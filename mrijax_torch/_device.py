"""Device handling shared by the entry points."""

from typing import Union

import torch


def require_device(device: Union[str, torch.device]) -> torch.device:
    """Resolve ``device`` and raise if it names CUDA where there is none.

    Entry points default to ``"cuda"`` and never move work to the CPU on
    their own: a caller who wants the CPU says ``device="cpu"``.
    """
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} was asked for but torch.cuda.is_available() is "
            "False; pass device='cpu' to run on the CPU"
        )
    return dev
