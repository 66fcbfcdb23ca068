"""Per-byte device ops: the hand kernels and their plain versions."""
