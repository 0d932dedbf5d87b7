"""The embodied coordinator layer: procedural vocal events, the prosody
policies and breath planning (the embodied agent itself is not ported yet)."""
