"""Frozen copy of the port's chemistry stack (see ../__init__.py)."""
