"""The port's H100 benchmark (see README.md)."""
