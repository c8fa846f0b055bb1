"""Volume renderer."""
