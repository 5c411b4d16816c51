"""Host-side IO of the port: images, windows, the native host engine."""
