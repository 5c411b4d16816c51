"""Demo programs of the port."""
