"""Command-line entry points, flag-compatible with ``stutter_tpu.cli``."""
