"""Models of the port (counterpart of muon_tpu/models): MOFA+ so far."""
