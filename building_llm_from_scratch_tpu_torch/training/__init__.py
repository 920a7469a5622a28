"""Parameter loading."""
