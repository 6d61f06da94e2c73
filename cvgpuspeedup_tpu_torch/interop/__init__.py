"""interop subpackage of the port."""
