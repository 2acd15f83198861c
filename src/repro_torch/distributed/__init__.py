"""Placement over devices: the sharding rules of the token LMs and the
streaming engine's slot state (``sharding.py``), and the int8 gradient
codec with error feedback (``compression.py``)."""
