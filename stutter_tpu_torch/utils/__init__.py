"""The per-run logfile (``logging``), the profiling hooks (``profiling``) and
the FLOP models with the card's peaks (``benchmarking``)."""

from stutter_tpu_torch.utils.logging import get_logger, setup_logging
