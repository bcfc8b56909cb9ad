"""Utilities of the port: metrics logging and the PNG writer."""
