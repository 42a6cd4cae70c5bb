"""Multi-stream execution."""
