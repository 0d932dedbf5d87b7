"""Text frontend: phoneme vocabulary and grapheme-to-phoneme backends."""
