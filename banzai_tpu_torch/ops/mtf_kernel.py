"""Kernel K1: the within-chunk MTF shuffle (``csrc/mtf_shuffle.cu``).

Counterpart of ``banzai_tpu/ops/mtf_pallas.py`` (``mtf_shuffle_pallas``).
``mtf_shuffle`` launches the CUDA kernel for a CUDA tensor and runs the
plain PyTorch version, ``mtf_shuffle_plain``, for a CPU tensor.  Symbols
are byte values or -1 (pad); the state rows hold byte values.
"""

from __future__ import annotations

import torch

from .._build import launch
from ..spans import read_int

S = 256


def _check(syms: torch.Tensor, state0: torch.Tensor) -> None:
    if syms.dim() != 2 or state0.dim() != 2:
        raise ValueError("syms must be [C, K] and state0 [C, 256]")
    if state0.shape != (syms.shape[0], S):
        raise ValueError(f"state0 shape {tuple(state0.shape)} != [C, 256]")
    if syms.dtype != torch.int32 or state0.dtype != torch.int32:
        raise TypeError("syms and state0 must be int32")
    if syms.device != state0.device:
        raise ValueError("syms and state0 lie on different devices")


def _raise_on_error_bits(err: torch.Tensor) -> None:
    bad = read_int(err.max()) if err.numel() else 0
    if bad:
        raise AssertionError(
            f"MTF kernel invariant violated (error bits {bad:#x}): "
            "recency state is not a byte permutation (bit 0: a symbol "
            "matched no slot, bit 1: more than one, bit 2: a state value "
            "outside 0..255)"
        )


def mtf_shuffle_plain(
    syms: torch.Tensor, state0: torch.Tensor, debug_checks: bool = False
) -> torch.Tensor:
    """Plain PyTorch version: a K-step loop over all C chunks at once.

    syms int32 [C, K] (pad -1), state0 int32 [C, 256].  Returns int32
    [C, K]: the position of each symbol in its chunk's recency state
    before it moves to the front, and -1 for a pad symbol.
    """
    _check(syms, state0)
    C, K = syms.shape
    state = state0.clone()
    col = torch.arange(S, device=syms.device, dtype=torch.int32)[None, :]
    out = torch.empty((C, K), dtype=torch.int32, device=syms.device)
    err = torch.zeros(C, dtype=torch.int32, device=syms.device)
    if debug_checks:
        err |= ((state0 < 0) | (state0 > 255)).any(dim=1).to(torch.int32) << 2
    for t in range(K):
        s = syms[:, t : t + 1]                                  # [C, 1]
        hit = state == s
        found = hit.any(dim=1)
        idx = torch.where(
            found, hit.to(torch.int32).argmax(dim=1).to(torch.int32), -1
        )
        out[:, t] = idx
        if debug_checks:
            valid = s[:, 0] >= 0
            nhit = hit.sum(dim=1)
            err |= (valid & (nhit == 0)).to(torch.int32)
            err |= (valid & (nhit > 1)).to(torch.int32) << 1
        shifted = torch.cat([s, state[:, :-1]], dim=1)
        keep = col > idx[:, None]
        state = torch.where(keep, state, shifted)
    if debug_checks:
        _raise_on_error_bits(err)
    return out


def mtf_shuffle(
    syms: torch.Tensor, state0: torch.Tensor, debug_checks: bool = False
) -> torch.Tensor:
    """Run the MTF shuffle on ``syms``' device: the CUDA kernel for a CUDA
    tensor, the plain version for a CPU tensor.  ``debug_checks`` also
    checks that every valid symbol sits in exactly one state slot, and
    raises if one does not."""
    if syms.device.type == "cpu":
        return mtf_shuffle_plain(syms, state0, debug_checks)
    _check(syms, state0)
    if syms.device.type != "cuda":
        raise ValueError(f"unsupported device {syms.device}")
    if not (syms.is_contiguous() and state0.is_contiguous()):
        raise ValueError("syms and state0 must be contiguous")
    if state0.data_ptr() % 16:
        raise ValueError("state0 must be 16-byte aligned")
    C, K = syms.shape
    out = torch.empty((C, K), dtype=torch.int32, device=syms.device)
    err = torch.zeros(C if debug_checks else 1, dtype=torch.int32,
                      device=syms.device)
    # 16-byte copies of whole rows when every row starts 16-byte aligned.
    vec = int(K % 4 == 0 and syms.data_ptr() % 16 == 0)
    with torch.cuda.device(syms.device):
        launch("mtf_shuffle", syms, state0, out, err, C, K, vec,
               int(debug_checks))
    if debug_checks:
        _raise_on_error_bits(err)
    return out
