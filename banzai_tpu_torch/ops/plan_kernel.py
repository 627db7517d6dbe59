"""Kernel K5: the entropy plan of a batch of blocks (``csrc/entropy_plan.cu``).

Replaces no TPU kernel: the JAX package's plan is plain ``jnp``.  The
entry point computes the dict of ``huffman.plan_entropy_plain`` bitwise,
in 13 kernels a call; ``huffman.plan_entropy`` launches it for CUDA
tensors and runs the plain version for CPU tensors.
"""

from __future__ import annotations

import torch

from .._build import launch
from ..constants import MAX_SYMS as S, MAX_TABLES as T

# The layout of the entry's scratch (``entropy_plan.cu``,
# ``scratch_bytes_for``): int32 symbol counts [B, S], per-table counts of
# each of the 4 refinement iterations [4, B, 20, S] and banzai's split
# [B, 3, S]; then bytes: code lengths [B, 21, S], pseudo tables [B, 3, S],
# the candidates' selectors and their MTF indices [B, 5, nseg rounded up
# to 16] each; then int32 MTF bits [B, 5].
_K, _BNT, _NC = 20, 3, 5


def plan_scratch_bytes(B: int, nseg: int) -> int:
    nsp = -(-nseg // 16) * 16
    return (4 * B * S * (1 + 4 * _K + _BNT) + B * S * (_K + 1 + _BNT)
            + 2 * B * _NC * nsp + 4 * B * _NC)


def entropy_plan(
    syms: torch.Tensor, out_len: torch.Tensor,
    num_syms: torch.Tensor, nseg: int,
) -> dict:
    """``huffman.plan_entropy`` on the card: syms int32 [B, M], out_len
    [B], num_syms [B] on one CUDA device; the same dict of int64 tensors.
    Raises for any other device."""
    dev = syms.device
    if dev.type != "cuda":
        raise ValueError(f"entropy_plan: unsupported device {dev}")
    if syms.dim() != 2 or syms.dtype != torch.int32:
        raise ValueError("entropy_plan: syms must be int32 [B, M]")
    B, M = syms.shape
    if not 1 <= B <= 65535 or not 1 <= nseg or nseg * 50 >= 1 << 29:
        raise ValueError(f"entropy_plan: B = {B}, nseg = {nseg} out of range")
    for name, t in (("out_len", out_len), ("num_syms", num_syms)):
        if t.shape != (B,) or t.device != dev or t.is_floating_point():
            raise ValueError(
                f"entropy_plan: {name} must be integer [{B}] on {dev}, got "
                f"{t.dtype} {tuple(t.shape)} on {t.device}")
    # No copy on the main path: out_len comes as int32, num_syms as int64.
    syms = syms.contiguous()
    out_len = out_len.to(torch.int32).contiguous()
    num_syms = num_syms.to(torch.int64).contiguous()

    def i64(*shape):
        return torch.empty(shape, dtype=torch.int64, device=dev)

    out = {
        "num_tables": i64(B), "tables": i64(B, T, S), "selectors": i64(B, nseg),
        "sel_mtf_idx": i64(B, nseg), "total_bits": i64(B),
        "nseg_used": i64(B), "banzai_split": i64(B, _BNT, S),
    }
    nbytes = plan_scratch_bytes(B, nseg)
    scratch = torch.empty(nbytes, dtype=torch.uint8, device=dev)
    with torch.cuda.device(dev):
        launch("entropy_plan", syms, out_len, num_syms, out["num_tables"],
               out["tables"], out["selectors"], out["sel_mtf_idx"],
               out["total_bits"], out["nseg_used"], out["banzai_split"],
               scratch, nbytes, B, M, nseg)
    return out
