"""The port's command-line tools: ``tnaf`` and ``untnaf``."""
