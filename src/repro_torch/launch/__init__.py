"""Launchers of the port (``repro.launch``): LM serving, one-shot batch."""
