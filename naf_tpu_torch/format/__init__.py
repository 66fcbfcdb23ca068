"""NAF format constants, VLE numbers and the container (copies of
``naf_tpu/format``)."""
