"""ops subpackage of the port."""
