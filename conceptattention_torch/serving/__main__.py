"""`python -m conceptattention_torch.serving`: run the generation daemon.

Builds the pipeline once (checkpoints from the spec's environment variables,
`weights/convert.py`, else random weights), then serves until interrupted
(SIGTERM drains the queue first). It runs on `--device` (cuda by default)
and raises without a card unless `--device cpu` is asked for. Flag names
follow the CLI's where they overlap.
"""

import argparse
import json
import logging
import signal
import threading


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="conceptattention_torch.serving",
        description="Micro-batched HTTP serving daemon for concept-attention generation",
    )
    p.add_argument("--model_name", "--model", dest="model_name", default="flux-schnell",
                   help="config registry key")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8000, help="0 picks a free port")
    p.add_argument("--device", default="cuda", help="torch device (cuda by default)")
    p.add_argument("--quantize", default=None, choices=["w8", "w8a8", "w4"],
                   help="quantized layer stacks (w8a8: int8 activations too; w4: "
                        "group-wise int4, about 6 GB for full flux)")
    p.add_argument("--attention_backend", default="fused", choices=["fused", "sdpa"],
                   help="fused: the flash-saliency kernels; sdpa: the plain path")
    p.add_argument("--int8_qk", action="store_true",
                   help="attention scores from int8 q and k (fused backend)")
    p.add_argument("--lora", nargs="+", default=None, metavar="PATH",
                   help="LoRA adapter .safetensors path(s), merged at load")
    p.add_argument("--lora_strength", type=float, nargs="+", default=None)
    p.add_argument("--lora_swap", action="store_true",
                   help="enable POST /v1/loras runtime adapter swaps (keeps a host copy "
                        "of the pre-merge weights: host memory of the model's size)")
    p.add_argument("--max_batch", type=int, default=8, help="largest coalesced batch")
    p.add_argument("--max_wait_ms", type=float, default=25.0,
                   help="how long a batch waits for stragglers")
    p.add_argument("--bucket_sizes", type=int, nargs="+", default=[1, 2, 4, 8],
                   help="padded batch sizes")
    p.add_argument("--request_timeout_s", type=float, default=600.0)
    p.add_argument("--max_queue_depth", type=int, default=64,
                   help="admission control: queued requests beyond this get HTTP 503 + "
                        "Retry-After instead of waiting toward the request timeout "
                        "(0 = unbounded)")
    p.add_argument("--video", dest="video_model", default=None, metavar="NAME",
                   const="cogvideox-5b", nargs="?",
                   help="also serve POST /v1/generate_video from a CogVideoX video "
                        "pipeline (cogvideox-5b, cogvideox-2b or cogvideox-tiny; bare "
                        "--video = cogvideox-5b). Shares the worker thread with image "
                        "traffic")
    p.add_argument("--warmup", default=None, metavar="JSON",
                   help='run one batch per bucket before listening, e.g. \'{"prompt": "w", '
                        '"concepts": ["object"], "width": 1024, "height": 1024, '
                        '"num_inference_steps": 4}\'')
    p.add_argument("--log_level", default="INFO")
    return p


def video_config(name: str):
    """The CogVideoX config of a `--video` name."""
    from conceptattention_torch.models.video.dit import CogVideoXConfig, cogvideox_5b_config

    if name == "cogvideox-5b":
        return cogvideox_5b_config()
    if name == "cogvideox-2b":
        return CogVideoXConfig()
    if name == "cogvideox-tiny":
        return CogVideoXConfig(
            num_attention_heads=4, attention_head_dim=16, time_embed_dim=32,
            text_embed_dim=64, num_layers=2, max_text_seq_length=16,
            use_rotary_positional_embeddings=True,
        )
    raise ValueError(f"unknown --video model {name!r} "
                     "(expected cogvideox-5b, cogvideox-2b or cogvideox-tiny)")


def main(argv=None) -> None:
    parser = build_parser()
    args = parser.parse_args(argv)
    logging.basicConfig(
        level=getattr(logging, args.log_level.upper(), logging.INFO),
        format="%(asctime)s %(name)s %(levelname)s %(message)s",
    )
    import torch

    from conceptattention_torch.pipeline.concept_pipeline import ConceptAttentionFluxPipeline
    from conceptattention_torch.serving import ConceptAttentionServer, GenerateRequest

    dtype = torch.bfloat16 if args.device.startswith("cuda") else torch.float32
    pipeline = ConceptAttentionFluxPipeline(
        args.model_name, dtype=dtype, device=args.device, quantize=args.quantize or False,
        attention_backend=args.attention_backend, int8_qk=args.int8_qk,
        lora=args.lora, lora_strength=args.lora_strength or 1.0,
        keep_base_for_swap=args.lora_swap,
    )
    video_pipeline = None
    if args.video_model:
        from conceptattention_torch.pipeline.video_pipeline import VideoConceptAttentionPipeline

        try:
            vcfg = video_config(args.video_model)
        except ValueError as e:
            parser.error(str(e))
        video_pipeline = VideoConceptAttentionPipeline(
            cfg=vcfg, dtype=dtype, device=args.device, quantize=args.quantize or False)

    server = ConceptAttentionServer(
        pipeline,
        video_pipeline=video_pipeline,
        host=args.host,
        port=args.port,
        max_batch=args.max_batch,
        max_wait_ms=args.max_wait_ms,
        bucket_sizes=args.bucket_sizes,
        request_timeout_s=args.request_timeout_s,
        max_queue_depth=args.max_queue_depth or None,
    )
    if args.warmup:
        print("warming up (one batch per bucket)...", flush=True)
        server.warmup(GenerateRequest.from_json(json.loads(args.warmup)))

    # SIGTERM (the usual stop signal): stop accepting connections, finish
    # the in-flight and queued batches, then exit.
    def _term(_signum, _frame):
        threading.Thread(target=server.stop, daemon=True).start()

    signal.signal(signal.SIGTERM, _term)
    print(f"serving {args.model_name} on {args.device} at http://{args.host}:{server.port}",
          flush=True)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        server.stop()


if __name__ == "__main__":
    main()
