"""data subpackage of the port: CircularTensor."""
