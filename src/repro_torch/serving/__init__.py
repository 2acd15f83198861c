"""Serving: the streaming RSNN (backends' op tables, slot scheduling, the
engine and its slot loops, sharded serving) and the token LMs
(``engine.py``'s ``generate`` and ``ServeLoop``, ``cache_utils.py``)."""
