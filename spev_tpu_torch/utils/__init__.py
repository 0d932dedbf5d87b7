"""Device selection, checkpoint naming and WAV I/O."""
