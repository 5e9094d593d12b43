"""schema subpackage."""
