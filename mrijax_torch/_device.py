"""Device handling shared by the entry points."""

from typing import Union

import torch


def require_device(device: Union[str, torch.device]) -> torch.device:
    """Resolve ``device`` and raise if it names CUDA where there is none.

    Entry points default to ``"cuda"`` and never move work to the CPU on
    their own: a caller who wants the CPU says ``device="cpu"``. A "cuda"
    without an index resolves to the current card, which
    ``parallel.initialize`` sets to the process's ``LOCAL_RANK`` before its
    NCCL group is made, so every rank works on its own card.
    """
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} was asked for but torch.cuda.is_available() is "
            "False; pass device='cpu' to run on the CPU"
        )
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev
