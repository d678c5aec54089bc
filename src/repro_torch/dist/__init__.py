"""Sharding rules of the port's distributed train steps."""
