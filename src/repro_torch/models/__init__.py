"""The LM stack: layers, attention, Mamba-2 and the model families."""
