"""Data-parallel training over ranks (``mesh.py``)."""
