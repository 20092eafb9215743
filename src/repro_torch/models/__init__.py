"""Models of the port (``repro.models``): the CNN zoo so far."""
