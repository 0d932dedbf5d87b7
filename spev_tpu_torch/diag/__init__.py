"""Training diagnostics: the metrics log and objective quality numbers."""
