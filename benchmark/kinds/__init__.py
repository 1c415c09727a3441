"""The traffic kinds, one module a kind (see ../harness.py)."""
