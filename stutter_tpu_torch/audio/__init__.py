"""Host audio runtime: the numpy RIFF/WAVE reader and writer."""
