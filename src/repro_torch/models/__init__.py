"""Dense decoder layers and model assembly (port of `repro.models`)."""
