"""Frozen copy of the port's host assembler (see ../__init__.py)."""
