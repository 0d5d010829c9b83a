"""Resilience: crash-safe checkpoint I/O (``ckpt_io``)."""
