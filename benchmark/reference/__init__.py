"""Plain references that decide `correct` (see unet.py, decode.py)."""
