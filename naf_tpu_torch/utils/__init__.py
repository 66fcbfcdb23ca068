"""Host helpers of the port (copies of ``naf_tpu/utils``)."""
