"""Block data parallelism: the devices one encode runs on.

Counterpart of ``banzai_tpu/parallel/dp.py``.  There, ``block_mesh`` made
a 1-D mesh of the host's devices and ``encode_blocks_sharded``
shard_mapped the per-batch body over it, ``ndev * 2`` blocks a dispatch.
Here the blocks of a batch need no collective either, so the scheduler
(``pipeline.compress_blocks_iter``) runs one device thread per entry of
``block_devices`` and each thread takes whole batches of the per-level
size from one queue.  The per-batch body stays ``block.encode_batch_rows``.
A block's payload does not depend on the batch it rides in, so the stream
is the same on any number of devices.

Several cards are opt-in: ``device`` names them as a sequence.  ``"cuda"``
stays the current card, because device threads in one process share the
interpreter lock; one process per card (``parallel/multihost.py``) does
not.
"""

from __future__ import annotations

from collections.abc import Sequence

import torch

from .._device import resolve_device

# What an entry point's ``device`` may be: one device or a sequence.
Devices = str | torch.device | Sequence[str | torch.device]


def block_devices(device: Devices = "cuda") -> list[torch.device]:
    """The devices an encode runs on, one device thread each.

    * a sequence: exactly those devices, each resolved as
      ``_device.resolve_device`` does, all of one type.  Repeats are
      allowed (two threads on one card, or on the CPU);
    * one device: that device alone (``"cuda"`` is the current card).

    ``"cuda"`` without a card raises."""
    if isinstance(device, (str, torch.device)):
        return [resolve_device(device)]
    devs = [resolve_device(d) for d in device]
    if not devs:
        raise ValueError("no device given")
    if len({d.type for d in devs}) > 1:
        raise ValueError(f"devices of more than one type: {devs}")
    return devs
