"""Executable code: a skewed low-order byte model.

Stands in for Silesia's mozilla and ooffice.  Instructions are tokens of
1-7 bytes drawn by Zipf popularity from a table (from the parameters'
``table_seed``, the same for every run) whose bytes follow a Zipf law
over a fixed byte order (opcodes and small operands dominate).  A share
of the instructions carries a 4-byte little-endian operand that walks in
small steps (addresses of nearby code and data).
"""

from __future__ import annotations

import numpy as np

from ..gen_util import gather, zipf_ranks


def generate(rng: np.random.Generator, nbytes: int, params: dict) -> bytes:
    ntok = int(params["tokens"])
    table = np.random.default_rng(params["table_seed"])
    order = table.permutation(256).astype(np.uint8)
    tlens = table.integers(1, 8, ntok)
    tbytes = order[zipf_ranks(table, 256, float(params["byte_zipf_s"]), int(tlens.sum()))]
    tstarts = np.concatenate([[0], np.cumsum(tlens)[:-1]])
    base = int(params["operand_base"])
    out = np.zeros(0, np.uint8)
    while len(out) < nbytes:
        n = 65536
        tok = zipf_ranks(rng, ntok, float(params["token_zipf_s"]), n)
        has_op = rng.random(n) < params["operand_share"]
        step = rng.integers(-params["operand_step"], params["operand_step"] + 1, n)
        base += int(step.sum())
        ops = (base - np.cumsum(step[::-1])[::-1]).astype("<u4")
        # One piece per instruction token, then one per operand (if any).
        src = np.concatenate([tbytes, ops.view(np.uint8)])
        starts = np.stack([tstarts[tok], len(tbytes) + 4 * np.arange(n)], 1).ravel()
        lens = np.stack([tlens[tok], np.where(has_op, 4, 0)], 1).ravel()
        out = np.concatenate([out, gather(src, starts, lens)])
    return out[:nbytes].tobytes()
