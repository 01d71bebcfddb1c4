"""stutter_tpu_torch — the PyTorch and CUDA port of ``stutter_tpu`` for NVIDIA Hopper.

It runs WavLM and Whisper embedding extraction into the reference's
``.npy``+CSV store from local HF checkpoints and fine-tunes WavLM, on one
GPU or data- and tensor-parallel on several (``parallel``: one process a
card over ``torch.distributed``), trains the downstream classifiers on the
store, and serves embeddings and predictions (JSONL and HTTP). Module names
mirror ``stutter_tpu``: ``models.wavlm`` and ``models.whisper``;
``ops.wavlm_attention``, ``ops.flash_mha`` and ``ops.logmel`` (each a
hand-written CUDA kernel from ``csrc/`` and its plain version);
``frontend``, ``weights``, ``audio``, ``extract``, ``train``, ``report``,
``serve``, ``parallel`` and ``cli``. The package imports torch, numpy and
the standard library only: never jax, pandas or ``stutter_tpu``; sklearn
and matplotlib only inside the functions that need them.
"""

__version__ = "0.3.0"
