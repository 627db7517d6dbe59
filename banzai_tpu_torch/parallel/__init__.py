"""The parallel layer: block data parallelism across cards and the
multi-process encode over ``torch.distributed``.

Counterpart of ``banzai_tpu/parallel/`` (``dp.py``, ``multihost.py``,
``serial.py``):

* ``dp.block_devices`` gives the devices one encode runs on; the
  scheduler (``pipeline.compress_blocks_iter``) runs one device thread per
  entry, each taking whole batches, where the JAX package shard_mapped
  each batch over a mesh;
* ``multihost.encode_multihost`` / ``encode_multihost_path`` spread an
  encode over the ranks of a process group: rank 0 plans spans on block
  boundaries, each rank encodes its span on its own device, and the
  payloads (``serial.BlockPayload.to_bytes``) are gathered to rank 0;
* ``_worker`` is one rank's command line.

Importing this package imports no torch.
"""
