"""Device selection: always explicit, never a silent fallback."""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device) -> torch.device:
    """The ``torch.device`` for ``device``.

    ``"cuda"`` (or ``"cuda:N"``) without a usable CUDA device raises: a run
    asked for the card never quietly becomes a CPU run.  ``"cpu"`` runs the
    plain PyTorch versions of the kernels.
    """
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {str(device)!r} requested but CUDA is not available"
            )
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {str(device)!r}")
    return dev
