"""Host utilities of the port (``pool.spawn_pool``)."""
