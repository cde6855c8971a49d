"""Server-side pieces the port needs (counterpart of
``presto_tpu/server``): the task output buffer."""
