"""Parallel training helpers of the port (single device so far)."""
