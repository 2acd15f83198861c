"""Streaming serving: backends (op tables), slot scheduling, the engine
and its synchronous slot loop."""
