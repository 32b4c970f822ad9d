"""Fault-tolerance substrate of the port."""
