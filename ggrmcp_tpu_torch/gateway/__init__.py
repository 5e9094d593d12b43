"""gateway subpackage."""
