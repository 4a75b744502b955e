"""Observability of the port: request tracing and the metrics renderer."""
