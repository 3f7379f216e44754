"""Framework version (a copy of ``mila_tpu/version.py``): the
``framework_version`` that archives and checkpoints record."""

__version__ = "0.1.0"

VERSION_MAJOR = 0
VERSION_MINOR = 1
VERSION_PATCH = 0


def get_api_version() -> str:
    """Return the semantic version string of the framework API."""
    return __version__
