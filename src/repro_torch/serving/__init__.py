"""Serving tier of the port: the supervised BatchingServer."""
