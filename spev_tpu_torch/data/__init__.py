"""Feature cache, bucketed batches and batch prefetching."""
