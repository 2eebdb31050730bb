"""Entry points of the port: the sync training launcher."""
