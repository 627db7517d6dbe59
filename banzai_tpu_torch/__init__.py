"""banzai_tpu_torch — the banzai_tpu bzip2 encoder in PyTorch and CUDA.

The per-block pipeline (BWT -> MTF -> RLE2 -> entropy plan -> bit packing)
runs as batched PyTorch tensor code on one CUDA device, with three
hand-written CUDA kernels (``csrc/``) for the MTF shuffle, the RLE2
expansion and the word assembly.  The host side (RLE1 block splitting,
CRCs, container framing, the host encoder for tiny blocks) is reused from
``banzai_tpu``'s JAX-free modules.  Output is byte-identical to
``banzai_tpu.encoder_host.compress``.

Public API:

* ``compress(data, level=9, device="cuda") -> bytes``

``device`` is explicit: ``"cuda"`` without a CUDA device raises, and
``"cpu"`` runs the kernels' plain PyTorch versions.
"""

from __future__ import annotations

from .pipeline import EncodeStats, compress as _compress

__version__ = "0.1.0"

__all__ = ["EncodeStats", "compress"]


def compress(
    data: bytes,
    level: int = 9,
    device: str = "cuda",
    stats: EncodeStats | None = None,
) -> bytes:
    """One-shot encode of ``data`` at ``level`` (block size level*100kB)
    on ``device``.  ``stats``, when given, receives the block route counts
    (and the stage times, if its ``stage_ms`` is a dict)."""
    if not 1 <= level <= 9:
        raise ValueError(f"level must be in 1..9, got {level}")
    return _compress(data, level, device, stats=stats)
