"""The tests' fixtures (``tiny_cells``)."""
from tiny_cells import tiny_root  # noqa: F401
