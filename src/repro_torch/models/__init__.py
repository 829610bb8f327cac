"""The model stack behind serving (torch): layers, attention, Mamba-2, MoE, the decoder."""
