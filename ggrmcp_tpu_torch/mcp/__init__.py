"""mcp subpackage."""
