"""%: 100 x the least time K1 (``csrc/mtf_shuffle.cu``) could take over
the device time of its kernels in the profiled part.

The least time reads each BWT symbol once and writes its MTF index once,
a byte each, at the card's memory rate.  The symbols are the RLE1 bytes
of every block that goes to the device, which this reader counts from
the jobs' bytes with the reference's RLE1 (blocks over ``TINY`` bytes:
the port encodes a stream's tiny last block on the host)."""

from ..peaks import bound_s
from ..reference.rle1 import iter_blocks

TINY = 16384          # RLE1 bytes at or below which a block stays on the host
BYTES_PER_SYMBOL = 2


def read(run):
    p = run.parts.get("profile")
    if p is None:
        return None
    k1_s = p.trace.kernel_time("mtf_shuffle")
    if k1_s <= 0:
        return None
    symbols = 0
    for d in p.window.completed:
        for blk in iter_blocks(d.job.data(run.pool), run.level):
            if len(blk.output) > TINY:
                symbols += len(blk.output)
    return 100.0 * bound_s(symbols * BYTES_PER_SYMBOL) / k1_s
