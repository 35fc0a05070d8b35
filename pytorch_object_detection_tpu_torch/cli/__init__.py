"""Command-line entry points of the port (``pyproject.toml`` ``[project.scripts]``)."""
