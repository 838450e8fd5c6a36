"""Stencil ops: the plain PyTorch stencil and the kernel wrappers."""
