"""Command-line entry points."""
