"""Serializable per-block payloads, the unit of the multi-process gather.

Counterpart of ``banzai_tpu/parallel/serial.py``.  The class lives in
``payload.py``, which the single-process pipeline uses too; this module
names it where the JAX package has it.
"""

from ..payload import BlockPayload

__all__ = ["BlockPayload"]
