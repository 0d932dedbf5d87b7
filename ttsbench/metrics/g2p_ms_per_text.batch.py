"""Front end: host milliseconds inside `G2P.phonemes` per text synthesized
(the rules G2P, as `Synthesizer.synthesize_many` calls it)."""

from ttsbench.lib.readers import host_ms_per


def read(ctx):
    return host_ms_per(ctx, "G2P.phonemes", "texts")
