"""Placement over devices: the streaming engine's slot state split on its
slot dimension (``sharding.py``)."""
