"""Core tools of the port (counterpart of muon_tpu/_core)."""
