"""Sharding rules over named mesh axes (pure functions; no process group)."""
