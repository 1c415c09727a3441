"""Frozen copy of the port's vocabulary (see ../__init__.py)."""
