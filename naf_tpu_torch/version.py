__version__ = "0.1.0"

# Version string reported by the CLIs (`tnaf --version`, `untnaf --version`).
TOOL_DATE = "2026-08-17"
