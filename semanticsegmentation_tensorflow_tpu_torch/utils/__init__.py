"""Utilities of the port (metrics logging)."""
