"""Mesh, halo exchange and the sharded rounds (``mesh.py``; 2D:
``halo.py``, ``temporal.py``; 3D: ``halo3d.py``, ``temporal3d.py``)."""
