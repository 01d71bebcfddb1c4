"""Corpus scanner, bucketed batcher, extraction pipeline, store and checkpoints."""
