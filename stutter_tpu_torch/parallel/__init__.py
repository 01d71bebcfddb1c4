"""Data and tensor parallelism over ``torch.distributed`` (counterpart of ``stutter_tpu/parallel``).

``mesh``: the [data, model] plan of the ranks, the worker launcher, row
sharding and host gathers; ``sharding``: cutting WavLM and Whisper to a
rank's Megatron share; ``collectives``: the tensor-parallel operators;
``dryrun``: one sharded fine-tune step on n ranks.
"""
