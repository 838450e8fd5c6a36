"""Measurement tools of the port that run kernels of their own."""
