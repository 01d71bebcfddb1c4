"""stutter_tpu_torch — the PyTorch and CUDA port of ``stutter_tpu`` for NVIDIA Hopper.

It runs WavLM and Whisper embedding extraction into the reference's
``.npy``+CSV store on one GPU. Module names mirror ``stutter_tpu``:
``models.wavlm`` and ``models.whisper``; ``ops.wavlm_attention``,
``ops.flash_mha`` and ``ops.logmel`` (each a hand-written CUDA kernel from
``csrc/`` and its plain version); ``frontend``, ``weights``, ``audio``,
``extract`` and ``cli``. The package imports torch, numpy and the standard
library only: never jax, pandas or ``stutter_tpu``.
"""

__version__ = "0.2.0"
