"""Synthetic storage-node data (a copy of `repro.data`)."""
from repro_torch.data.pipeline import Prefetcher, StorageNodeDataset  # noqa: F401
