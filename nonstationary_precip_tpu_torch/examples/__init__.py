"""Counterparts of the examples/ quickstarts."""
