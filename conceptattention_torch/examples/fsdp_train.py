"""Fine-tune the Flux DiT with FSDP (ZeRO-3) over a device mesh.

Counterpart of the JAX package's `examples/fsdp_train.py`: the parameters
and AdamW moments fully sharded over the `data` axis of the mesh
(`parallel/fsdp.py`), composed with tensor parallelism over `model`, driven
through the training loop (warmup-cosine schedule, gradient accumulation,
EMA, checkpoint and resume) on the tiny config and random data.

Without `--real_devices` every rank of the mesh sits on one device (a
virtual mesh, as the JAX script builds one of virtual CPU devices): the
card by default, or `--device cpu`. With it, rank i takes card i.

    python -m conceptattention_torch.examples.fsdp_train            # virtual 4 x 2 mesh
    python -m conceptattention_torch.examples.fsdp_train --data 2 --model 2 --steps 10
"""

import argparse
import os
import sys

# Allow running as a plain script from anywhere: put the repo root (two
# levels up) on sys.path so `conceptattention_torch` imports without install.
sys.path.insert(0, os.path.abspath(os.path.join(os.path.dirname(__file__), "..", "..")))


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--data", type=int, default=4, help="FSDP/data axis size")
    parser.add_argument("--model", type=int, default=2, help="TP axis size")
    parser.add_argument("--steps", type=int, default=5)
    parser.add_argument("--batch", type=int, default=8)
    parser.add_argument("--ckpt_dir", default=None, help="checkpoint dir")
    parser.add_argument("--real_devices", action="store_true",
                        help="one card per rank instead of a virtual mesh on one device")
    parser.add_argument("--device", default="cuda", help="torch device (cuda by default)")
    args = parser.parse_args(argv)

    import torch

    from conceptattention_torch.config import configs
    from conceptattention_torch.models.flux.params import init_flux_params
    from conceptattention_torch.ops.packing import make_img_ids
    from conceptattention_torch.parallel import (
        AXES,
        NamedSharding,
        P,
        flux_fsdp_sharding,
        make_mesh,
        shard_params_fsdp,
    )
    from conceptattention_torch.training import TrainConfig, train_loop

    dev = torch.device(args.device)
    n = args.data * args.model
    if args.real_devices:
        devices = [torch.device(dev.type, i) for i in range(n)]
    else:
        devices = [dev] * n
    cfg = configs["flux-tiny"].params
    mesh = make_mesh(data=args.data, model=args.model, devices=devices)
    print(f"mesh: data={args.data} (FSDP+DP) x model={args.model} (TP) on "
          f"{'cards ' + ', '.join(map(str, devices)) if args.real_devices else f'one {dev}'}")

    dense = init_flux_params(torch.Generator(dev).manual_seed(0), cfg, torch.float32)
    param_sharding = flux_fsdp_sharding(dense, mesh, cfg)
    params = shard_params_fsdp(dense, mesh, cfg)
    del dense
    qkv = params["double"]["img_qkv"]["w"]
    print(f"qkv weight {tuple(qkv.shape)} -> per-rank shard {tuple(qkv.grid.flat[0].shape)}")

    b, grid, t = args.batch, (4, 4), 4

    def make_batch(seed):
        gen = torch.Generator(dev).manual_seed(seed)
        return dict(
            img=torch.randn((b, grid[0] * grid[1], cfg.in_channels), generator=gen, device=dev),
            img_ids=make_img_ids(*grid, batch_size=b, device=dev),
            txt=torch.randn((b, t, cfg.context_in_dim), generator=gen, device=dev),
            txt_ids=torch.zeros((b, t, 3), device=dev),
            y=torch.randn((b, cfg.vec_in_dim), generator=gen, device=dev),
        )

    batch_sharding = {k: NamedSharding(mesh, P(AXES.data)) for k in make_batch(1)}
    result = train_loop(
        params,
        cfg,
        data=(make_batch(100 + i) for i in range(args.steps)),
        tc=TrainConfig(
            total_steps=args.steps, warmup_steps=1, learning_rate=1e-4,
            log_every=1, checkpoint_dir=args.ckpt_dir,
        ),
        mesh=mesh,
        param_sharding=param_sharding,
        batch_sharding=batch_sharding,
    )
    print(f"done: final loss {result['losses'][-1]:.4f} at step {result['step']}")


if __name__ == "__main__":
    main()
