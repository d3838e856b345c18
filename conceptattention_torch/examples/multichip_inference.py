"""Mesh-sharded inference: generate with the DiT tensor-parallel over ranks.

Counterpart of the JAX package's `examples/multichip_inference.py`. The
mesh is `--data` x `--model` (default: `model` = the cards there are over
`data`). Where it has more ranks than there are cards, ranks share them (a
virtual mesh: on one card, every rank is on card 0, as the JAX script runs
on virtual CPU devices):

    python -m conceptattention_torch.examples.multichip_inference --model 2
    python -m conceptattention_torch.examples.multichip_inference --data 1 --model 2 \\
        --tiny --device cpu
"""

import argparse
import os
import sys

# Allow running as a plain script from anywhere: put the repo root (two
# levels up) on sys.path so `conceptattention_torch` imports without install.
sys.path.insert(0, os.path.abspath(os.path.join(os.path.dirname(__file__), "..", "..")))


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--model_name", default="flux-schnell")
    parser.add_argument("--data", type=int, default=1)
    parser.add_argument("--model", type=int, default=None,
                        help="tensor-parallel width (default: all cards over data)")
    parser.add_argument("--tiny", action="store_true")
    parser.add_argument("--prompt", default="A dragon standing on a rock")
    parser.add_argument("--concepts", nargs="+", default=["dragon", "rock", "sky"])
    parser.add_argument("--size", type=int, default=None)
    parser.add_argument("--steps", type=int, default=4)
    parser.add_argument("--device", default="cuda", help="torch device (cuda by default)")
    args = parser.parse_args(argv)

    import torch

    from conceptattention_torch import ConceptAttentionFluxPipeline
    from conceptattention_torch.parallel import make_mesh

    dev = torch.device(args.device)
    cards = ([torch.device("cuda", i) for i in range(torch.cuda.device_count())]
             if dev.type == "cuda" else [dev])
    n = len(cards)
    model = args.model if args.model is not None else max(n // args.data, 1)
    if model < 1 or args.data < 1:
        raise SystemExit(f"invalid mesh: data={args.data} model={model}")
    ranks = args.data * model
    mesh = make_mesh(data=args.data, model=model,
                     devices=[cards[i % n] for i in range(ranks)])
    print(f"mesh: data={args.data} model={model} over {n} device(s)"
          + (f" ({ranks} ranks sharing them)" if ranks > n else ""))

    dtype = torch.bfloat16 if dev.type == "cuda" else torch.float32
    if args.tiny:
        args.model_name = "flux-tiny"
        size = args.size or 64
    else:
        size = args.size or 1024
    pipe = ConceptAttentionFluxPipeline(args.model_name, dtype=dtype, mesh=mesh)

    out = pipe.generate_image(
        prompt=args.prompt, concepts=args.concepts,
        width=size, height=size, num_inference_steps=args.steps,
    )
    out.image.save("multichip_output.png")
    print("wrote multichip_output.png with", len(out.concept_heatmaps), "heatmaps")


if __name__ == "__main__":
    main()
