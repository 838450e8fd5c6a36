"""File I/O and timing helpers."""
