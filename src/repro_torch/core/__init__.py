"""Cluster-side pieces of the training driver (port of `repro.core`)."""
