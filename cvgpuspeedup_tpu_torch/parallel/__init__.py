"""parallel subpackage of the port: the batch axis sharded over a device mesh."""
