"""utils subpackage of the port."""
