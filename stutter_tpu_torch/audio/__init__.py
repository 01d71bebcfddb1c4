"""Host audio runtime: the native (C++) WAV parser, resampler and batch
decoder, libav's compressed formats where the host has them, the numpy
plain versions, and synthetic corpora."""
