"""Host I/O of the port (copies of ``mpp_tpu/io`` modules it needs)."""
