"""Host-side data: task splits, resize tables, synthetic datasets, pipeline."""
