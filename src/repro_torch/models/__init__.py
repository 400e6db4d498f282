"""Model code of the port: the dense transformer's paged serving path."""
