"""Command-line entry points of the port, and the data mesh (``mesh``)."""
