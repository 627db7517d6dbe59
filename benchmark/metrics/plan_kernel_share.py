"""%: the share of the device blocks whose entropy plan kernel K5
computed (``EncodeStats.plan_kernel_blocks`` over ``device_blocks``, x
100), in the part of the traced window with ``EncodeStats`` alone.
Nothing to read where the program has no such counter, or no device
block."""


def read(run):
    p = run.parts.get("host")
    stats = p.stats if p else None
    planned = getattr(stats, "plan_kernel_blocks", None)
    if planned is None or not getattr(stats, "device_blocks", 0):
        return None
    return 100.0 * planned / stats.device_blocks
