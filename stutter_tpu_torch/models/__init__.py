"""WavLM in PyTorch."""
