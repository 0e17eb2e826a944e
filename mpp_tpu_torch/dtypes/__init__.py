"""Host data types of the port: meshes, connection sets, conditions,
regions and the MPP builder base (copies of ``mpp_tpu/dtypes``)."""
