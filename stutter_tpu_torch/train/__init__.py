"""Fine-tuning WavLM end to end (counterpart of ``stutter_tpu/train``'s fine-tune path)."""
