"""Measurement scripts for the port (run with ``python -m``; nothing runs at import)."""
