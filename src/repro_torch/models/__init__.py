"""Models of the port (``repro.models``): the CNN zoo and the dense LM stack."""
