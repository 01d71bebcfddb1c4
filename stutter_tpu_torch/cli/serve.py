"""Online embedding server CLI on one or many GPUs (flags of ``stutter_tpu.cli.serve``, plus ``--device``).

Reads JSONL requests (``{"id": ..., "path": ...}`` or bare audio paths) from
stdin or a file, batches them with a latency deadline onto the extraction
pipeline's extractors, and writes JSONL responses to stdout (embeddings
inline) or ``.npy`` files under ``--output_dir`` (responses then carry the
file's path):

    echo '{"id": "a", "path": "/data/clip.wav"}' | \\
      python -m stutter_tpu_torch.cli.serve --model_type wavlm --model_name <checkpoint dir>

With ``--http HOST:PORT`` the same loop serves a network endpoint instead
(``serve/http.py``): ``POST /embed`` with ``{"path": ...}`` JSON or raw audio
bytes (WAV; FLAC, MP3, OGG where the host has libav); ``GET /stats``,
``GET /healthz``. ``--model_name`` (and, for
``combined``, ``--whisper_model_name``) names a local HF checkpoint
directory, or with ``--random_init`` the architecture to build from seed 0;
a hub name raises ``OSError``. ``--classifier_model`` takes a model the
port's trainer wrote (``{base}_model.npz`` or ``.pkl``). ``--device`` names
the torch device (default ``cuda``).

``--devices N`` runs N processes, one per card (default: every visible
card), and ``--tp T`` cuts the model over T of them; under ``torchrun`` the
CLI joins its group (``cli.common.run_on_devices``). Rank 0 reads the
requests, runs the serving loop, classifies and writes every response (to
stdout or ``--output_dir``; over HTTP it alone binds the address); the other
ranks follow its rounds (``EmbeddingServer.follow``), each decoding its own
rows of each batch from the paths rank 0 sends. So every rank must see the
same files at the same paths, rank 0's temporary directory too, where raw
HTTP bodies are spooled (``TMPDIR``).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile

import numpy as np

from stutter_tpu_torch.cli.common import add_mesh_args
from stutter_tpu_torch.utils.logging import get_logger, setup_logging


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description="Online embedding server (PyTorch/CUDA)")
    parser.add_argument("--model_type", type=str, default="wavlm",
                        choices=["wavlm", "wavlm_large", "whisper", "whisper_large_fixed",
                                 "combined"])
    parser.add_argument("--model_name", type=str, default=None,
                        help="Local HF checkpoint directory (default name by model_type; "
                             "for 'combined' this names the WavLM part)")
    parser.add_argument("--whisper_model_name", type=str, default="openai/whisper-large",
                        help="'combined' only: the Whisper part's checkpoint")
    parser.add_argument("--input", type=str, default="-",
                        help="JSONL request source ('-' = stdin)")
    parser.add_argument("--http", type=str, default=None, metavar="HOST:PORT",
                        help="Serve over HTTP instead of JSONL stdin/file "
                             "(POST /embed, GET /stats, GET /healthz)")
    parser.add_argument("--request_timeout_s", type=float, default=120.0,
                        help="HTTP mode: per-request deadline before a 422 timeout")
    parser.add_argument("--output_dir", type=str, default=None,
                        help="Write each clip's embeddings as .npy here instead "
                             "of inlining them in the response JSON")
    parser.add_argument("--max_wait_ms", type=float, default=250.0,
                        help="Max time the first queued request waits for batchmates")
    parser.add_argument("--max_clips", type=int, default=64,
                        help="Max clips gathered per serving round")
    parser.add_argument("--buckets", type=str, default=None,
                        help="Comma-separated bucket lengths in seconds (default: the "
                             "extractor's preference, 30 for whisper/combined)")
    parser.add_argument("--long_clip_policy", type=str, default="chunk",
                        choices=["trim", "chunk"],
                        help="Clips longer than the top bucket: 'chunk' embeds "
                             "length-weighted top-bucket chunks, 'trim' keeps "
                             "only the first bucket-length seconds")
    parser.add_argument("--classifier_model", type=str, default=None,
                        help="A trained {...}_model.npz or .pkl (the train CLI's) with its "
                             "_info.json sidecar; responses then carry the predicted "
                             "label and probabilities")
    parser.add_argument("--warmup", action="store_true",
                        help="Run one silent batch per bucket before taking traffic")
    parser.add_argument("--random_init", action="store_true",
                        help="Random weights from seed 0 (no checkpoint load)")
    add_mesh_args(parser)
    parser.add_argument("--preset", type=str, default="fast",
                        choices=["fast", "fidelity", "turbo"],
                        help="Numerics preset: fast=bf16, fidelity=f32 without TF32, "
                             "turbo=fast with int8 W8A8 projections")
    parser.add_argument("--device", type=str, default="cuda",
                        help="Torch device to run on (default: cuda)")
    return parser.parse_args(argv)


def build_server_extractor(args, model_name: str, device, plan=None):
    """The extractor of ``--model_type`` (both parts for 'combined', on the
    same plan), or None."""
    from stutter_tpu_torch.cli.train import build_extractor_for

    if args.model_type == "combined":
        from stutter_tpu_torch.serve.combined import CombinedExtractor

        return CombinedExtractor(
            build_extractor_for("wavlm", model_name, args.random_init, device, args.preset,
                                plan),
            build_extractor_for("whisper", args.whisper_model_name, args.random_init, device,
                                args.preset, plan))
    return build_extractor_for(args.model_type, model_name, args.random_init, device,
                               args.preset, plan)


def response_line(resp, output_dir: str | None) -> dict:
    """One JSONL response: embeddings inline, or saved under ``output_dir``."""
    obj = {"id": resp.req_id, "path": resp.path, "ok": bool(resp.ok)}
    if resp.ok and resp.prediction is not None:
        obj["prediction"] = resp.prediction
        if resp.probs is not None:
            obj["probs"] = resp.probs
    if resp.ok and resp.error:  # embeddings shipped, the classification failed
        obj["error"] = resp.error
    if not resp.ok:
        obj["error"] = resp.error
    elif output_dir:
        stem = os.path.splitext(os.path.basename(resp.path))[0]
        base = os.path.join(output_dir, f"{resp.req_id}_{stem}")
        if len({np.asarray(v).shape[-1] for v in resp.embeddings.values()}) == 1:
            fname = base + ".npy"
            np.save(fname, np.stack(list(resp.embeddings.values())))
        else:  # ragged columns (combined): one npz keyed by column
            fname = base + ".npz"
            np.savez(fname, **{k: np.asarray(v, np.float32) for k, v in resp.embeddings.items()})
        obj["file"] = fname
        obj["columns"] = list(resp.embeddings.keys())
    else:
        obj["embeddings"] = {k: np.asarray(v, np.float32).tolist()
                             for k, v in resp.embeddings.items()}
    return obj


def main(argv=None) -> int:
    args = parse_args(argv)
    setup_logging("serve")
    logger = get_logger("cli.serve")
    # the listen address is checked before the model is built
    http_host = http_port = None
    if args.http:
        http_host, _, port_str = args.http.rpartition(":")
        if not port_str.isdigit():
            logger.error("--http expects HOST:PORT, got %r", args.http)
            return 2
        http_port = int(port_str)

    from stutter_tpu_torch.cli.common import (
        build_plan,
        default_model_name,
        make_bucket_batcher,
        rank_device,
        run_on_devices,
    )

    # a bad --tp fails here too, before any model is built or rank spawned
    rc = run_on_devices("stutter_tpu_torch.cli.serve", argv, args,
                        args.output_dir or tempfile.gettempdir())
    if rc is not None:
        return rc

    from stutter_tpu_torch.serve.server import EmbeddingServer, jsonl_requests

    plan = build_plan(args)
    leads = plan is None or plan.rank == 0
    device = rank_device(args, plan)
    model_name = default_model_name(args.model_type, args.model_name)
    extractor = build_server_extractor(args, model_name, device, plan)
    if extractor is None:
        logger.error("unsupported model_type %s", args.model_type)
        return 1

    classifier = None
    if args.classifier_model and leads:
        from stutter_tpu_torch.serve.classify import ServingClassifier

        classifier = ServingClassifier.load(args.classifier_model, device=device)

    buckets = tuple(float(b) for b in args.buckets.split(",")) if args.buckets else None
    server = EmbeddingServer(
        extractor,
        batcher=make_bucket_batcher(extractor, plan=plan, buckets_s=buckets,
                                    audio_budget_s=args.max_clips * 3.0,
                                    max_batch=args.max_clips),
        max_wait_s=args.max_wait_ms / 1e3, max_clips=args.max_clips,
        long_clip_policy=args.long_clip_policy, classifier=classifier)
    if args.warmup:
        logger.info("warmup: %d bucket batches run", extractor.warmup(server.batcher))
    if not leads:
        logger.info("rank %d follows rank 0's rounds", plan.rank)
        server.follow()
        return 0

    if args.http:
        from stutter_tpu_torch.serve.http import HttpEmbeddingFrontend

        frontend = HttpEmbeddingFrontend(server, host=http_host or "127.0.0.1",
                                         port=http_port,
                                         request_timeout_s=args.request_timeout_s)
        logger.info("HTTP serving (model=%s) on %s:%d", model_name, frontend.host,
                    frontend.port)
        try:
            frontend.serve_forever()
        finally:
            logger.info("final serving stats: %s", server.stats())
        return 0

    if args.output_dir:
        os.makedirs(args.output_dir, exist_ok=True)

    def emit(resp):
        sys.stdout.write(json.dumps(response_line(resp, args.output_dir)) + "\n")
        sys.stdout.flush()

    if args.input != "-":
        source = open(args.input)
    elif plan is not None:  # a spawned rank's sys.stdin is /dev/null: fd 0 is the caller's
        source = open(0, closefd=False)
    else:
        source = sys.stdin
    try:
        logger.info("serving (model=%s, max_wait=%.0f ms, max_clips=%d)", model_name,
                    args.max_wait_ms, args.max_clips)
        server.serve(jsonl_requests(source), emit)
    finally:
        logger.info("final serving stats: %s", server.stats())
        if source is not sys.stdin:
            source.close()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
