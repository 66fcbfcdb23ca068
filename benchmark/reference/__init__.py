"""The benchmark's plain reference: NAF archives and their rendered text.

A frozen, torch-free copy of ``naf_tpu_torch``'s host stack (``constants``,
``vle``, ``container``; the library path of the codec over the system
libzstd; the numpy parser, encoder and decoder; the numpy helpers), with its
imports rewritten, plus ``records``, which builds an archive from the
records a generator made.  It imports nothing of ``naf_tpu_torch``, ``jax``
or ``naf_tpu``: later changes to the program cannot move it.
"""
