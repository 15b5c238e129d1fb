"""Parameter conversion and loading."""
