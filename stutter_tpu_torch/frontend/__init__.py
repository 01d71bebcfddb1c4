"""Model input frontends: the WavLM waveform norm."""
