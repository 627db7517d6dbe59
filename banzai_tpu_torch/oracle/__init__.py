"""Executable oracles: naive NumPy/Python re-implementations of every stage
(the reference's debug/*.py pattern) plus a full model of the banzai
algorithm — quirks included — used for size-parity anchors in tests/bench.

Copy of ``banzai_tpu/oracle/__init__.py``, so the port imports nothing of
the JAX package; only the imports differ, and the output is byte for byte
the original's.
"""

from .stages import naive_bwt, numpy_bwt, naive_mtf_rle2
from .banzai_model import banzai_compress
