"""Sharding rules of the multi-device layout (``sharding.py``)."""
