"""Device selection: always explicit, never a silent fallback."""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device) -> torch.device:
    """The ``torch.device`` for ``device``.

    ``"cuda"`` (or ``"cuda:N"``) without a usable CUDA device raises, and
    so does ``"cuda:N"`` past the visible cards: a run asked for a card
    never quietly becomes a CPU run.  ``"cpu"`` runs the plain PyTorch
    versions of the kernels.
    """
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {str(device)!r} requested but CUDA is not available"
            )
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        elif dev.index >= torch.cuda.device_count():
            raise RuntimeError(
                f"device {str(device)!r} requested but only "
                f"{torch.cuda.device_count()} CUDA devices are visible"
            )
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {str(device)!r}")
    return dev
