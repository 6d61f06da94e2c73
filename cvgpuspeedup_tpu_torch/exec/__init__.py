"""exec subpackage of the port."""
