"""Container header, dtype registry and enums (copies of the JAX package's
format-bearing host modules, so the port imports nothing of it)."""
from . import dtypes, enums, header  # noqa: F401
