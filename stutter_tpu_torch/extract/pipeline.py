"""Batched, resumable WavLM, wav2vec2, w2v-BERT and Whisper embedding extraction.

Counterpart of ``stutter_tpu/extract/pipeline.py``: the split loop feeds
length-bucketed batches through ``WavLMExtractor``, ``Wav2Vec2Extractor``
(wav2vec 2.0 / XLS-R, which the JAX package lacks; one device),
``W2VBertExtractor`` (w2v-BERT 2.0, which it lacks too; one device) or
``WhisperExtractor`` and writes the reference's .npy+CSV store with
checkpoint/resume. ``submit``
enqueues a batch's device work and the copy of its pooled result on the
current CUDA stream without waiting for either, and ``collect`` waits for
that copy alone, so the pipeline keeps one batch in flight while it stores
the previous one.

Files longer than the top bucket are trimmed to it (``long_file_policy=
"trim"``, the reference's behaviour) or cut into top-bucket chunks whose
pooled embeddings are combined, weighted by each chunk's true frame count
(``"chunk"``): ``chunked_embeddings`` does one file (the server's long
clips), ``ExtractionPipeline`` packs the chunks of all long files into the
same full-size bucket batches.

Given a ``parallel.mesh.MeshPlan`` (``plan=``), the extractors cut the model
to the rank's tensor-parallel share (``parallel.sharding``), and the
pipeline runs data-parallel: every rank runs the same batcher over the same
file list, decodes and encodes only its rows of each batch
(``parallel.mesh.shard_rows``), and rank 0 gathers the pooled rows over the
host group and alone writes the store and the checkpoints. A resumed run
reads the same checkpoint on every rank, after a barrier. Files to chunk are
decoded on every rank (the chunks of a batch come from several files), each
rank encoding its rows of each chunk batch. ``submit_rows`` and
``collect_rows`` are that step for every caller (the pipeline, the server,
``chunked_embeddings``, the augmentation's re-extraction): enqueue this
rank's rows of a global batch, then collect them and gather every data
rank's rows to rank 0.

Spans (``utils.profiling.span``): ``extract.submit`` with its children
``extract.pin`` (the bf16 presets' int16 encoding of the batch on the host,
then its pinned host-to-device copies) and ``extract.encode`` (the model's
enqueue; its attrs name the model ``family`` and its attention's
``head_dim``; w2v-BERT's holds ``frontend.fbank``, its fbank, and
``w2v_bert.layers``, whose ``relkey_attn_launches`` counts the batch's
relative-key attention launches); ``extract.collect_wait`` (the host's wait
for a batch's result); ``extract.rows`` (a batch's rows built for the store); ``extract.checkpoint``
and ``extract.store`` (in ``checkpoint.py`` and ``store.py``).
"""

from __future__ import annotations

import contextlib
import dataclasses
import itertools
import logging
import struct
import time
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Sequence

import numpy as np
import torch

from stutter_tpu_torch.audio.wavio import audio_info, load_audio
from stutter_tpu_torch.extract.batcher import DEFAULT_BUCKETS_S, Batch, BucketBatcher
from stutter_tpu_torch.extract.checkpoint import (
    find_latest_checkpoint,
    load_checkpoint,
    save_checkpoint,
)
from stutter_tpu_torch.extract.store import save_embeddings
from stutter_tpu_torch.frontend.w2v_bert_frontend import (
    w2v_bert_features,
    w2v_bert_frame_lengths,
)
from stutter_tpu_torch.frontend.wavlm_frontend import wavlm_prepare_batch
from stutter_tpu_torch.frontend.whisper_frontend import whisper_features
from stutter_tpu_torch.models.w2v_bert import W2VBertModel
from stutter_tpu_torch.models.wav2vec2 import Wav2Vec2Config, Wav2Vec2Model
from stutter_tpu_torch.models.wavlm import (
    LONG_ATTENTION_MIN_L,
    WavLMModel,
    materialized_bias_attention,
    wavlm_feature_lengths,
)
from stutter_tpu_torch.models.whisper import WhisperModel
from stutter_tpu_torch.ops._attention import HEAD_DIM, HEAD_DIMS
from stutter_tpu_torch.ops.logmel import WHISPER_HOP
from stutter_tpu_torch.ops.precision import no_tf32
from stutter_tpu_torch.ops.quant import (
    W2V_BERT_QUANT_KEYS,
    WAVLM_QUANT_KEYS,
    WHISPER_QUANT_KEYS,
    quantize_layer_stack,
)
from stutter_tpu_torch.ops.relkey_attention import relkey_attention
from stutter_tpu_torch.parallel.mesh import (
    MeshPlan,
    barrier,
    broadcast_round,
    gather_rows,
    shard_rows,
)
from stutter_tpu_torch.parallel.sharding import shard_wavlm, shard_whisper
from stutter_tpu_torch.utils.profiling import span

logger = logging.getLogger("stutter_tpu_torch.extract.pipeline")

PRESETS = {
    # fidelity: f32 parameters and activations, no TF32 anywhere
    "fidelity": dict(dtype=torch.float32, transfer_i16=False),
    # fast: the whole parameter set in bf16 (norms included), f32 norm
    # statistics, attention softmax and pooling; int16 waveform transfer
    "fast": dict(dtype=torch.bfloat16, transfer_i16=True),
    # turbo: fast, then int8 W8A8 projections (ops/quant.py): WavLM's
    # q/k/v/o and FFN, the Whisper encoder's q/k/v and FFN (its attn_o and the
    # whole decoder stay bf16). Inference only; its fidelity is measured, not
    # held to the 1e-3 bar.
    "turbo": dict(dtype=torch.bfloat16, transfer_i16=True),
    # turbo_ffn: the step between turbo and fast, int8 on the FFN GEMMs only
    "turbo_ffn": dict(dtype=torch.bfloat16, transfer_i16=True),
}

_FFN_QUANT_KEYS = ("feed_forward.w1", "feed_forward.w2", "ffn.fc1_w", "ffn.fc2_w")


def cast_for_preset(model, device: torch.device, preset: str):
    """Move the float32 model to ``device`` in the preset's dtype and, for the
    turbo presets, quantize the encoder layers' weights from that bf16 cast
    (quantizing the f32 weights would give other int8 values than JAX's), as
    ``cast_params_for_preset`` does: turbo takes WavLM's six keys, the
    Whisper encoder's but ``attn.o_w`` and every product of w2v-BERT's
    layers, turbo_ffn the FFN's (WavLM's and Whisper's). The Whisper
    decoder, the conv stems, biases, norms and embeddings keep the preset's
    dtype."""
    model = model.to(device=device, dtype=PRESETS[preset]["dtype"]).eval()
    whisper = isinstance(model, WhisperModel)
    turbo = (WHISPER_QUANT_KEYS if whisper
             else W2V_BERT_QUANT_KEYS if isinstance(model, W2VBertModel) else WAVLM_QUANT_KEYS)
    keys = {"turbo": turbo, "turbo_ffn": _FFN_QUANT_KEYS}.get(preset)
    if keys:
        quantize_layer_stack((model.encoder if whisper else model).layers, keys)
    return model


def encode_waves_i16(waves) -> tuple[np.ndarray, np.ndarray]:
    """Per-clip peak-scaled int16 host->device encoding (the bf16 presets').

    Scaling each clip to the full int16 range bounds the quantisation noise
    at ~3e-5 relative to that clip's peak. Returns (int16 [B, T], f32 scale
    [B])."""
    w = np.asarray(waves, np.float32)
    peak = np.max(np.abs(w), axis=1)
    scale = np.where(peak > 0, peak / 32767.0, 1.0).astype(np.float32)
    q = np.clip(np.rint(w / scale[:, None]), -32767, 32767).astype(np.int16)
    return q, scale


def resolve_device(device: torch.device | str) -> torch.device:
    """The device asked for; a CUDA device with no card raises."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device} was requested but torch finds no CUDA device")
    return device


class _Extractor:
    """What both extractors share: the device, the preset's cast (and turbo's
    quantization) of the float32 model, and the batch loop's
    submit/collect/warmup. A subclass sets ``family`` (its model's, for the
    ``extract.encode`` span) and ``column_names`` (the order of
    ``_forward``'s [S, B, D] result) and defines ``_forward`` (and
    ``_inputs``, where it takes other tensors than the waves, their scales
    and sample counts). Under a
    ``plan`` the model is cut to the rank's tensor-parallel share after the
    cast (turbo quantizes the whole weights first, as the JAX package does),
    and a batch is this rank's rows of the global batch."""

    family: str
    column_names: list[str]

    def __init__(self, model, device: torch.device | str, preset: str,
                 plan: MeshPlan | None = None):
        if preset not in PRESETS:
            raise ValueError(f"unknown preset {preset!r}; choose from {sorted(PRESETS)}")
        self.cfg = model.cfg
        self.device = resolve_device(device)
        self.preset = preset
        self.plan = plan
        self._transfer_i16 = PRESETS[preset]["transfer_i16"]
        self.model = cast_for_preset(model, self.device, preset)

    def _precision(self):
        return no_tf32() if self.preset == "fidelity" else contextlib.nullcontext()

    def _to_device(self, a: np.ndarray) -> torch.Tensor:
        t = torch.from_numpy(a)
        if self.device.type == "cuda":  # pinned, so the copy does not wait
            t = t.pin_memory()
        return t.to(self.device, non_blocking=True)

    @staticmethod
    def _waves(waves: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
        """Device batch (f32, or int16 with per-clip scales) -> f32."""
        return waves.float() * scale[:, None]

    def _inputs(self, waves: np.ndarray, scale: np.ndarray, lengths: np.ndarray) -> tuple:
        """The host batch copied to the device (``_to_device``): the
        tensors ``_forward`` takes, here the waves, their scales and their
        sample counts."""
        return (self._to_device(waves), self._to_device(scale),
                self._to_device(lengths.astype(np.int64)))

    def _forward(self, *inputs: torch.Tensor) -> torch.Tensor:
        """Enqueue the model on ``_inputs``' tensors: [S, B, D] f32 pooled."""
        raise NotImplementedError

    def _encode(self, waves: np.ndarray, scale: np.ndarray,
                lengths: np.ndarray) -> torch.Tensor:
        return self._forward(*self._inputs(waves, scale, lengths))

    def submit(self, batch: Batch):
        """Enqueue the batch's device work and the copy of its [S, B, D] f32
        pooled result into pinned host memory, without waiting for either;
        returns (host tensor, CUDA event or None)."""
        with span("extract.submit", clips=len(batch.paths)):
            with span("extract.pin"):
                waves = batch.waves
                scale = np.ones((len(waves),), np.float32)
                if self._transfer_i16:
                    waves, scale = encode_waves_i16(waves)
                inputs = self._inputs(waves, scale, batch.lengths)
            with span("extract.encode", family=self.family, head_dim=self.cfg.head_dim):
                pooled = self._forward(*inputs)
            if self.device.type != "cuda":
                return pooled, None
            host = torch.empty(pooled.shape, dtype=pooled.dtype, pin_memory=True)
            host.copy_(pooled, non_blocking=True)
            done = torch.cuda.Event()
            done.record(torch.cuda.current_stream(self.device))
            return host, done

    def collect(self, handle) -> dict[str, np.ndarray]:
        host, done = handle
        with span("extract.collect_wait"):
            if done is not None:
                done.synchronize()  # this batch's copy only, not later batches
        pooled = host.numpy()
        return {name: pooled[s] for s, name in enumerate(self.column_names)}

    def __call__(self, batch: Batch) -> dict[str, np.ndarray]:
        return self.collect(self.submit(batch))

    def warmup(self, batcher: BucketBatcher) -> int:
        """Run one silent batch per bucket shape, at this rank's local batch
        size (builds the kernels, warms cuDNN and the allocator); returns the
        number of buckets run."""
        count = 0
        data = self.plan.data_size if self.plan is not None else 1
        for bucket_s in batcher.buckets_s:
            B, n = batcher.batch_size_for(bucket_s) // data, batcher.bucket_samples(bucket_s)
            t0 = time.perf_counter()
            waves = np.zeros((B, n), np.int16 if self._transfer_i16 else np.float32)
            self._encode(waves, np.ones((B,), np.float32), np.full((B,), n, np.int64)).cpu()
            logger.info("warmup: bucket %.1fs [B=%d, n=%d] ran in %.2fs",
                        bucket_s, B, n, time.perf_counter() - t0)
            count += 1
        return count


class WavLMExtractor(_Extractor):
    """Layer-selected mean-pooled WavLM embeddings.

    ``model`` is a float32 ``WavLMModel``; the extractor moves it to
    ``device`` and casts it for ``preset``. ``long_attention`` picks the
    attention of the long buckets: "gated" (the default, as in the JAX
    package) sends every call to ``gated_relpos_attention``;
    "materialized_bias" takes the JAX package's escape hatch
    (``models.wavlm.materialized_bias_attention``) from ``long_min_l``
    frames up, in bf16."""

    LONG_ATTENTION = ("gated", "materialized_bias")
    family = "wavlm"

    def __init__(self, model: WavLMModel, device: torch.device | str,
                 layer_indices: Sequence[int] | None = None, preset: str = "fidelity",
                 long_attention: str = "gated", long_min_l: int = LONG_ATTENTION_MIN_L,
                 plan: MeshPlan | None = None):
        if long_attention not in self.LONG_ATTENTION:
            raise ValueError(f"long_attention must be one of {self.LONG_ATTENTION}, "
                             f"got {long_attention!r}")
        super().__init__(model, device, preset, plan)
        shard_wavlm(self.model, plan)
        # None: encode's default, the gated kernel wrapper
        self.attention_fn = (materialized_bias_attention(long_min_l)
                             if long_attention == "materialized_bias" else None)
        cfg = self.cfg
        n_states = cfg.num_hidden_layers + 1
        # reference default: [N-1, N-2, N-3, N//2] of the N+1 states
        self.layer_indices = tuple(
            layer_indices if layer_indices is not None
            else (n_states - 1, n_states - 2, n_states - 3, n_states // 2))
        self.embedding_dim = cfg.hidden_size
        self.column_names = [f"layer_{i}" for i in self.layer_indices]
        self.frame_align = (*cfg.stem_geometry, 16)

    def frame_count(self, n_samples: int) -> int:
        return int(wavlm_feature_lengths(self.cfg, n_samples))

    def _forward(self, waves: torch.Tensor, scale: torch.Tensor, lens: torch.Tensor):
        w = wavlm_prepare_batch(self._waves(waves, scale), lens, self.cfg.do_normalize)
        with self._precision():
            return self.model.encode(w, self.layer_indices, sample_lengths=lens,
                                     attention_fn=self.attention_fn)


class Wav2Vec2Extractor(WavLMExtractor):
    """Layer-selected mean-pooled wav2vec 2.0 (XLS-R) embeddings, as
    ``WavLMExtractor`` gives WavLM's: the same frontend norm, frame-aligned
    buckets (so the fused stem runs), default layers, presets (turbo: int8
    q, k, v, o and FFN weights), store columns and forward; attention through
    ``flash_mha`` with each clip's key count. ``model`` is a float32
    ``Wav2Vec2Model``. One device: a ``plan`` of more than one rank raises,
    and so does a card with heads the tiles are not built at
    (``check_device``)."""

    family = "wav2vec2"

    def __init__(self, model: Wav2Vec2Model, device: torch.device | str,
                 layer_indices: Sequence[int] | None = None, preset: str = "fidelity",
                 plan: MeshPlan | None = None):
        if plan is not None and plan.world_size > 1:
            raise NotImplementedError("wav2vec2 extraction runs on one device; "
                                      f"got a plan of {plan.world_size} ranks")
        self.check_device(model.cfg, device)
        super().__init__(model, device, layer_indices, preset)

    @staticmethod
    def check_device(cfg: Wav2Vec2Config, device: torch.device | str) -> None:
        """Raise ValueError where ``device`` is a card and ``cfg``'s heads
        are not a width the attention tiles are built at (``HEAD_DIMS``):
        callers check before they load weights."""
        if torch.device(device).type == "cuda" and cfg.head_dim not in HEAD_DIMS:
            widths = " or ".join(map(str, HEAD_DIMS))
            raise ValueError(f"heads of {cfg.head_dim}: the attention kernel is built at "
                             f"head_dim {widths}")


class W2VBertExtractor(_Extractor):
    """Layer-selected mean-pooled w2v-BERT 2.0 embeddings, in the store
    columns, presets and default layers of ``WavLMExtractor`` (states N,
    N - 1, N - 2 and N // 2 of the N + 1; turbo: int8 in every product of
    the layers). Each batch's fbank (``frontend.w2v_bert_frontend``) runs on
    the device from the pinned waves, then the encoder on its rows.
    ``model`` is a float32 ``W2VBertModel``, its weights loaded (the
    macaron 1/2 and q's scale folded in at load, before the cast).
    Buckets are not frame-aligned: a bucket of n samples gives
    (1 + (n - 400) // 160) // 2 rows (999 at 20 s, 1499 at 30 s). One
    device: a ``plan`` of more than one rank raises, and so does a card
    with heads other than the tiles' 64 (``check_device``)."""

    family = "w2v_bert"
    frame_align = None

    def __init__(self, model: W2VBertModel, device: torch.device | str,
                 layer_indices: Sequence[int] | None = None, preset: str = "fidelity",
                 plan: MeshPlan | None = None):
        if plan is not None and plan.world_size > 1:
            raise NotImplementedError("w2v-BERT extraction runs on one device; "
                                      f"got a plan of {plan.world_size} ranks")
        self.check_device(model.cfg, device)
        super().__init__(model, device, preset)
        cfg = self.cfg
        n_states = cfg.num_hidden_layers + 1
        self.layer_indices = tuple(
            layer_indices if layer_indices is not None
            else (n_states - 1, n_states - 2, n_states - 3, n_states // 2))
        self.embedding_dim = cfg.hidden_size
        self.column_names = [f"layer_{i}" for i in self.layer_indices]

    @staticmethod
    def check_device(cfg, device: torch.device | str) -> None:
        """Raise ValueError where ``device`` is a card and ``cfg``'s heads
        are not the 64 the relative-key kernel is built at."""
        if torch.device(device).type == "cuda" and cfg.head_dim != HEAD_DIM:
            raise ValueError(f"heads of {cfg.head_dim}: the relative-key attention kernel is "
                             f"built at head_dim {HEAD_DIM}")

    def frame_count(self, n_samples: int) -> int:
        return int(w2v_bert_frame_lengths(int(n_samples), self.cfg.stride))

    def _forward(self, waves: torch.Tensor, scale: torch.Tensor, lens: torch.Tensor):
        cfg = self.cfg
        with self._precision():
            with span("frontend.fbank"):
                feats, rows = w2v_bert_features(self._waves(waves, scale), lens,
                                                cfg.num_mel_bins, cfg.stride, cfg.sampling_rate)
            with span("w2v_bert.layers") as s:
                before = relkey_attention.launches
                dtype = PRESETS[self.preset]["dtype"]
                pooled = self.model.encode(feats.to(dtype), self.layer_indices, rows)
                s.set(relkey_attn_launches=relkey_attention.launches - before)
        return pooled


class WhisperExtractor(_Extractor):
    """Whisper encoder mean-pooled and decoder single-token embeddings.

    Keeps the reference's quirks: the 30 s zero-padded mel is attended in
    full and the encoder pool is over all 1500 frames, padding included;
    the decoder runs exactly one step with token id 0. ``model`` is a
    float32 ``WhisperModel``; the extractor moves it to ``device`` and casts
    it for ``preset`` (fast: the whole tree in bf16, embeddings included)."""

    preferred_buckets = (30.0,)
    family = "whisper"

    def __init__(self, model: WhisperModel, device: torch.device | str,
                 encoder_indices: Sequence[int] | None = None,
                 decoder_indices: Sequence[int] | None = None, preset: str = "fidelity",
                 plan: MeshPlan | None = None):
        super().__init__(model, device, preset, plan)
        shard_whisper(self.model, plan)
        cfg = self.cfg
        n_enc, n_dec = cfg.encoder_layers + 1, cfg.decoder_layers + 1
        # reference: the last three hidden states of each
        self.encoder_indices = tuple(
            encoder_indices if encoder_indices is not None
            else (n_enc - 1, n_enc - 2, n_enc - 3))
        self.decoder_indices = tuple(
            decoder_indices if decoder_indices is not None
            else (n_dec - 1, n_dec - 2, n_dec - 3))
        self.embedding_dim = cfg.d_model
        self.column_names = ([f"encoder_layer_{i}" for i in self.encoder_indices]
                             + [f"decoder_layer_{i}" for i in self.decoder_indices])

    def frame_count(self, n_samples: int) -> int:
        """True encoder frames covering n_samples of audio (mel hop 160, conv
        stem stride 2), capped at the 1500 positions. The encoder itself
        still pools over all 1500 padded positions."""
        return max(1, min(self.cfg.max_source_positions, int(n_samples) // (WHISPER_HOP * 2)))

    def _inputs(self, waves: np.ndarray, scale: np.ndarray, lengths: np.ndarray) -> tuple:
        return self._to_device(waves), self._to_device(scale)

    def _forward(self, waves: torch.Tensor, scale: torch.Tensor):
        with self._precision():
            mel = whisper_features(self._waves(waves, scale), n_mels=self.cfg.num_mel_bins)
            return self.model.embed(mel, self.encoder_indices, self.decoder_indices)


@dataclasses.dataclass
class GatheredRows:
    """The real rows (pad rows dropped) of one global batch: on rank 0 every
    data rank's, in order."""

    columns: dict[str, np.ndarray]  # column -> [n, D] f32
    rows: list[int]
    paths: list[str]
    ok: np.ndarray  # [n] bool: False where the clip did not decode
    audio_seconds: float


def submit_rows(extractor, batch: Batch, *, sharded: bool = False):
    """Enqueue this data rank's rows of the global ``batch`` on the device
    without waiting (``shard_rows``: the ranks of a model group take the same
    rows); ``sharded``: ``batch`` already is this rank's rows, as
    ``BucketBatcher`` decodes them with ``shard=``. The real rows of a batch
    come first, so each rank's real rows are the first of its slice. Returns
    what ``collect_rows`` takes. An error while submitting is returned in
    the handle's place, so that this rank still joins the gather."""
    plan = getattr(extractor, "plan", None)
    if plan is not None and not sharded:
        mine = shard_rows(plan, len(batch.waves))
        batch = Batch(paths=batch.paths[mine], rows=list(batch.rows)[mine],
                      waves=batch.waves[mine], lengths=batch.lengths[mine], ok=batch.ok[mine],
                      bucket_s=batch.bucket_s, sample_rate=batch.sample_rate)
    try:
        return batch, extractor.submit(batch)
    except Exception as e:  # noqa: BLE001 — raised by collect_rows, after the gather
        return batch, e


def collect_rows(extractor, submitted) -> GatheredRows | None:
    """Collect ``submit_rows``' batch and gather every data rank's real rows
    to rank 0 over the host group: rank 0 gets them in global row order, the
    other ranks None. Every rank joins the gather whatever its own outcome;
    then a rank whose batch failed raises its error, and rank 0 raises one
    for any rank's failure."""
    batch, handle = submitted
    n = len(batch.rows)
    error = handle if isinstance(handle, Exception) else None
    cols = None
    if error is None:
        try:
            cols = {c: a[:n] for c, a in extractor.collect(handle).items()}
        except Exception as e:  # noqa: BLE001 — raised below, after the gather
            error = e
    plan = getattr(extractor, "plan", None)
    parts = gather_rows(plan, (cols, list(batch.rows), list(batch.paths), batch.ok[:n],
                               batch.audio_seconds, None if error is None else repr(error)))
    if error is not None:
        raise error
    if parts is None:
        return None
    failed = [(d, p[5]) for d, p in enumerate(parts) if p[5] is not None]
    if failed:
        raise RuntimeError("; ".join(f"data rank {d}: {e}" for d, e in failed))
    return GatheredRows(
        columns={c: np.concatenate([p[0][c] for p in parts]) for c in parts[0][0]},
        rows=[r for p in parts for r in p[1]], paths=[q for p in parts for q in p[2]],
        ok=np.concatenate([p[3] for p in parts]), audio_seconds=sum(p[4] for p in parts))


def chunked_embeddings(extractor, batcher: BucketBatcher, path: str,
                       ) -> tuple[dict[str, np.ndarray], int, float] | None:
    """Embed one over-length file as top-bucket chunks and combine the pooled
    embeddings weighted by each chunk's true frame count (in float64). For
    WavLM (mask-correct pooling) this is the whole-file mean pool up to the
    chunk boundaries; for Whisper (its pool over the padding kept) it weighs
    each chunk's padded pool by its real audio.

    The chunk count pads to a multiple of ``max(batch_multiple, 4)``, as in
    the JAX package, so few batch shapes are seen (and then to one of
    ``batch_multiple``, which the JAX package's multiples of 1, 2, 4 and 8
    already are). Under the extractor's plan every rank decodes the file and
    takes the chunk count rank 0 decoded (``broadcast_round``), so that all
    ranks submit the same chunk batch; each encodes its rows of it, and rank
    0 alone combines them: the other ranks return None. A rank that decodes
    another length fails the file.
    Returns (column -> combined [D] f32, n_chunks, audio seconds), or None
    when the file does not decode or no chunk has a frame."""
    sr = batcher.target_sr
    chunk_samples = batcher.bucket_samples(batcher.buckets_s[-1])
    plan = getattr(extractor, "plan", None)
    wave = load_audio(path, target_sr=sr)
    n_samples = None if wave is None else len(wave)
    if plan is not None:
        n_samples = broadcast_round(plan, n_samples)
    if n_samples is None:
        logger.error("skipping %s (decode failed)", path)
        return None
    decoded = wave is not None and len(wave) == n_samples
    if not decoded:
        wave = np.zeros((n_samples,), np.float32)
    n_chunks = max(1, -(-n_samples // chunk_samples))
    m = max(batcher.batch_multiple, 4)
    n_padded = -(-n_chunks // m) * m
    n_padded = -(-n_padded // batcher.batch_multiple) * batcher.batch_multiple
    waves = np.zeros((n_padded, chunk_samples), np.float32)
    lengths = np.zeros((n_padded,), np.int64)
    for c in range(n_chunks):
        seg = wave[c * chunk_samples: (c + 1) * chunk_samples]
        waves[c, : len(seg)] = seg
        lengths[c] = len(seg)
    ok = (np.arange(n_padded) < n_chunks) & decoded
    batch = Batch(paths=[path] * n_chunks, rows=list(range(n_chunks)), waves=waves,
                  lengths=lengths, ok=ok, bucket_s=chunk_samples / sr, sample_rate=sr)
    got = collect_rows(extractor, submit_rows(extractor, batch))
    if got is None:  # not rank 0
        return None
    if not got.ok.all():
        logger.error("skipping %s (decode failed on a rank)", path)
        return None
    embeddings = got.columns
    # a tiny tail chunk can come out of the conv stem with <= 0 frames: clamp
    weights = np.array([max(0, extractor.frame_count(int(n))) for n in lengths[:n_chunks]],
                       np.float64)
    if weights.sum() <= 0:
        logger.error("skipping %s (no usable chunks)", path)
        return None
    weights /= weights.sum()
    combined = {col: np.asarray((np.asarray(arr, np.float64) * weights[:, None]).sum(axis=0),
                                np.float32)
                for col, arr in embeddings.items()}
    return combined, n_chunks, float(n_samples) / sr


def _store_row(meta_row: dict, split: str) -> dict:
    entry = {"filename": meta_row["filename"], "path": meta_row["path"], "split": split}
    if meta_row.get("label") not in (None, ""):
        entry["label"] = meta_row["label"]
    return entry


class ExtractionPipeline:
    """Split loop -> bucketed batches -> device forward -> store.

    ``long_file_policy``: files longer than the top bucket keep their first
    top-bucket seconds ("trim", the reference's behaviour) or are embedded
    as top-bucket chunks combined by true frame count ("chunk"; their rows
    carry a ``chunks`` column).

    Under the extractor's ``plan`` the loop is data-parallel (see the
    module's docstring): the batcher's ``batch_multiple`` must be a multiple
    of the data size, and ``run_split`` returns the rows on rank 0 and an
    empty list on the other ranks, once rank 0 has written the store."""

    def __init__(self, extractor, batcher: BucketBatcher | None = None,
                 checkpoint_interval: int = 50, long_file_policy: str = "trim"):
        if long_file_policy not in ("trim", "chunk"):
            raise ValueError(f"long_file_policy must be 'trim' or 'chunk', "
                             f"got {long_file_policy!r}")
        self.long_file_policy = long_file_policy
        self.extractor = extractor
        self.plan = getattr(extractor, "plan", None)
        data = self.plan.data_size if self.plan is not None else 1
        if batcher is None:
            batcher = BucketBatcher(
                buckets_s=getattr(extractor, "preferred_buckets", None) or DEFAULT_BUCKETS_S,
                batch_multiple=data, frame_align=getattr(extractor, "frame_align", None))
        if batcher.batch_multiple % data:
            raise ValueError(f"the batcher's batch_multiple {batcher.batch_multiple} does not "
                             f"split over {data} data ranks")
        self.batcher = batcher
        self.checkpoint_interval = checkpoint_interval

    def run_split(self, metadata: list[dict], split: str, output_dir: str,
                  resume: bool = False) -> list[dict]:
        """Extract one split, honouring checkpoint/resume, and persist it."""
        split_rows = [r for r in metadata if r.get("split") == split]
        if not split_rows:
            logger.warning("no files for split %s", split)
            return []

        plan = self.plan
        results: list[dict] = []
        ckpt_num = 0
        if resume:
            barrier(plan)  # every rank reads the checkpoint rank 0 wrote last
            latest = find_latest_checkpoint(output_dir, split)
            if latest is not None:
                results = load_checkpoint(output_dir, split, latest)
                ckpt_num = latest
        done_paths = {r["path"] for r in results}
        todo = [r for r in split_rows if r["path"] not in done_paths]

        long_rows: list[int] = []
        if self.long_file_policy == "chunk":
            top_s = self.batcher.buckets_s[-1]
            for i, r in enumerate(todo):
                try:
                    n, sr = audio_info(r["path"])
                except (OSError, ValueError, struct.error):
                    continue  # the batch path reports the file
                if n / sr > top_s:
                    long_rows.append(i)
        long_set = set(long_rows)
        short_rows = [i for i in range(len(todo)) if i not in long_set]

        t0 = time.perf_counter()
        audio_s = 0.0
        since_ckpt = 0

        def checkpoint_if_due() -> None:
            """After each batch, and after each chunked file."""
            nonlocal since_ckpt, ckpt_num
            if since_ckpt >= self.checkpoint_interval:
                ckpt_num += 1
                save_checkpoint(results, output_dir, split, ckpt_num)
                since_ckpt = 0

        def drain(submitted, k: int) -> None:
            """Store batch k's rows: on rank 0, every data rank's, in order."""
            nonlocal audio_s, since_ckpt
            got = collect_rows(self.extractor, submitted)
            if got is None:  # not rank 0
                return
            audio_s += got.audio_seconds
            with span("extract.rows", batch=k) as s:
                for j, row_idx in enumerate(got.rows):
                    if not got.ok[j]:
                        logger.error("skipping %s (decode failed)", got.paths[j])
                        continue
                    entry = _store_row(todo[row_idx], split)
                    for col, arr in got.columns.items():
                        entry[col] = np.asarray(arr[j], np.float32)
                    results.append(entry)
                    since_ckpt += 1
                s.set(rows=int(got.ok.sum()))
            checkpoint_if_due()

        # 1-deep: batch i+1 is enqueued on the device before batch i's pooled
        # result is copied back and stored
        shard = None if plan is None else (plan.data_rank, plan.data_size)
        pending = None
        for k, batch in enumerate(self.batcher.batches([todo[i]["path"] for i in short_rows],
                                                       shard=shard)):
            batch.rows = [short_rows[r] for r in batch.rows]
            submitted = submit_rows(self.extractor, batch, sharded=True)
            if pending is not None:
                drain(*pending)
            pending = submitted, k
        if pending is not None:
            drain(*pending)

        if long_rows:
            def file_done(entry: dict) -> None:
                nonlocal audio_s, since_ckpt
                with span("extract.rows", rows=1):
                    audio_s += entry.pop("_audio_s")
                    results.append(entry)
                    since_ckpt += 1
                checkpoint_if_due()

            self._extract_chunked_rows(todo, long_rows, split, file_done)

        if plan is not None and plan.rank != 0:
            barrier(plan)  # until rank 0 has written the store
            return []
        wall = time.perf_counter() - t0
        if wall > 0 and audio_s > 0:
            logger.info("split %s: %d files, %.1f audio-s in %.1f s (%.1fx real-time)",
                        split, len(results), audio_s, wall, audio_s / wall)
        # the JAX package's store: columns in order of first appearance in
        # extraction order, rows sorted stably by path, and a chunks column
        # that is float where some rows lack it (pandas' int column with holes)
        columns = list(dict.fromkeys(c for r in results for c in r))
        results = sorted(results, key=lambda r: r["path"])
        n_chunked = sum("chunks" in r for r in results)
        if 0 < n_chunked < len(results):
            for r in results:
                if "chunks" in r:
                    r["chunks"] = float(r["chunks"])
        save_embeddings(results, output_dir, split,
                        expected_dim=self.extractor.embedding_dim, columns=columns)
        barrier(plan)
        return results

    def _extract_chunked_rows(self, todo: list[dict], long_rows: list[int], split: str,
                              on_file_done) -> None:
        """The chunk policy's batches: the chunks of all long files share
        full-size bucket batches (whole chunks ride the top bucket, each tail
        its smallest covering bucket), one batch in flight. Each file's
        pooled chunks are summed in float64, weighted by true frame count, as
        its batches drain; its row goes to ``on_file_done`` when its last
        chunk lands. Files decode on two host threads, at most four ahead.
        Under a plan every rank builds the same chunk batches, encodes its
        rows of each, and rank 0 gathers and combines them."""
        batcher = self.batcher
        sr = batcher.target_sr
        top_samples = batcher.bucket_samples(batcher.buckets_s[-1])
        acc: dict[int, dict] = {}  # row -> weighted sums, weight, chunks left
        pend: dict[float, tuple[list, list]] = {}  # bucket -> (segments, rows)
        inflight: list = []  # [(slot (row, weight) list, handle)]

        def finalize(row_idx: int) -> None:
            a = acc.pop(row_idx)
            if a["wsum"] <= 0:
                logger.error("skipping %s (no usable chunks)", a["path"])
                return
            meta_row = todo[row_idx]
            entry = {"filename": meta_row["filename"], "path": meta_row["path"],
                     "split": split, "chunks": a["n_chunks"], "_audio_s": a["audio_s"]}
            if meta_row.get("label") not in (None, ""):
                entry["label"] = meta_row["label"]
            for col, v in a["sums"].items():
                entry[col] = np.asarray(v / a["wsum"], np.float32)
            logger.info("chunked %s: %d chunks (%.1f s)", meta_row["filename"],
                        a["n_chunks"], a["audio_s"])
            on_file_done(entry)

        def drain_one() -> None:
            slots, submitted = inflight.pop(0)
            got = collect_rows(self.extractor, submitted)
            if got is None:  # not rank 0
                return
            embeddings = got.columns
            for slot, (row_idx, w) in enumerate(slots):
                a = acc[row_idx]
                if w > 0:
                    for col, arr in embeddings.items():
                        a["sums"][col] = a["sums"].get(col, 0.0) + np.asarray(
                            arr[slot], np.float64) * w
                    a["wsum"] += w
                a["remaining"] -= 1
                if a["remaining"] == 0:
                    finalize(row_idx)

        def submit_bucket(bucket_s: float) -> None:
            segs, rows = pend.pop(bucket_s)
            bsz, max_samples = batcher.batch_size_for(bucket_s), batcher.bucket_samples(bucket_s)
            waves = np.zeros((bsz, max_samples), np.float32)
            lengths = np.zeros((bsz,), np.int64)
            slots = []
            for s, (seg, row_idx) in enumerate(zip(segs, rows)):
                # a frame-aligned bucket can hold up to stride-1 samples under
                # its nominal seconds: trim as decode_batch does
                n = min(len(seg), max_samples)
                waves[s, :n] = seg[:n]
                lengths[s] = n
                slots.append((row_idx, float(max(0, self.extractor.frame_count(n)))))
            batch = Batch(paths=[todo[r]["path"] for r in rows], rows=list(rows), waves=waves,
                          lengths=lengths, ok=np.arange(bsz) < len(segs), bucket_s=bucket_s,
                          sample_rate=sr)
            inflight.append((slots, submit_rows(self.extractor, batch)))
            while len(inflight) > 1:  # 1-deep: drain the previous batch
                drain_one()

        def push(bucket_s: float, seg: np.ndarray, row_idx: int) -> None:
            segs, rows = pend.setdefault(bucket_s, ([], []))
            segs.append(seg)
            rows.append(row_idx)
            if len(segs) >= batcher.batch_size_for(bucket_s):
                submit_bucket(bucket_s)

        pool = ThreadPoolExecutor(max_workers=2)
        row_iter = iter(long_rows)
        futures: deque = deque()

        def schedule(row_idx: int) -> None:
            futures.append((row_idx, pool.submit(load_audio, todo[row_idx]["path"],
                                                 target_sr=sr)))

        try:
            for row_idx in itertools.islice(row_iter, 4):
                schedule(row_idx)
            while futures:
                row_idx, future = futures.popleft()
                nxt = next(row_iter, None)
                if nxt is not None:
                    schedule(nxt)
                path = todo[row_idx]["path"]
                wave = future.result()  # None when the file does not decode
                if wave is None:
                    logger.error("skipping %s (decode failed)", path)
                    continue
                n_chunks = max(1, -(-len(wave) // top_samples))
                acc[row_idx] = {"path": path, "sums": {}, "wsum": 0.0, "remaining": n_chunks,
                                "n_chunks": n_chunks, "audio_s": float(len(wave)) / sr}
                for c in range(n_chunks):
                    seg = wave[c * top_samples: (c + 1) * top_samples]
                    # the tail's bucket by sample cover, not nominal seconds
                    # (a frame-aligned bucket sits a sliver under them)
                    bucket = next((b for b in batcher.buckets_s
                                   if len(seg) <= batcher.bucket_samples(b)),
                                  batcher.buckets_s[-1])
                    push(bucket, seg, row_idx)
        finally:
            pool.shutdown(wait=False, cancel_futures=True)

        for bucket_s in list(pend):
            submit_bucket(bucket_s)
        while inflight:
            drain_one()

    def run(self, metadata: list[dict], output_dir: str,
            splits: Sequence[str] = ("train", "test", "devel"),
            resume: bool = False) -> dict[str, list[dict]]:
        return {s: self.run_split(metadata, s, output_dir, resume=resume) for s in splits}
