"""One-device counterparts of naf_tpu.parallel: encode and decode drivers."""
