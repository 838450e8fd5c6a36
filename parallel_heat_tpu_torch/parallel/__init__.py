"""Mesh, halo exchange and the sharded rounds (``mesh.py``, ``halo.py``,
``temporal.py``)."""
