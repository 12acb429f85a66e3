"""Serving entry points of the port: step factories and ``serve``."""
