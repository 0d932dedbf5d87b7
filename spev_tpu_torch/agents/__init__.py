"""The embodied coordinator layer: procedural vocal events, the prosody
policies, breath planning and the embodied agent."""
