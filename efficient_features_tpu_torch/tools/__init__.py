"""Measurement tools of the port (run on a machine with a CUDA card)."""
