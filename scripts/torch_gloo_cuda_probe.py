"""Which `gloo` collectives take CUDA tensors, two ranks on one card.

    python scripts/torch_gloo_cuda_probe.py [--device cuda|cpu]

Starts two ranks of itself on this machine (`gloo`, tcp://localhost), both
on cuda:0 (or the CPU), and on each rank tries `all_reduce`, `broadcast`,
`all_gather` (a list of tensors) and `all_gather_into_tensor` on tensors of
that device, checks the values, and times each on a 12 MiB tensor (a
1024² float32 image) with the host clock after a warm-up.  Prints one JSON
line per rank and, first, the card's name and power limit.  The sharded
path of the port (dpt_tpu_torch/dist/sharding.py) uses the first three.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def rank_main(rank, world, port, device):
    import torch
    import torch.distributed as dist

    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            world_size=world, rank=rank)
    dev = torch.device(device)
    out = {"rank": rank, "device": str(dev)}
    big = torch.full((1024 * 1024 * 3,), float(rank + 1), device=dev)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    def timed(fn):
        fn()
        sync()
        t0 = time.perf_counter()
        fn()
        sync()
        return (time.perf_counter() - t0) * 1e3

    def all_reduce():
        x = big.clone()
        dist.all_reduce(x)
        return bool((x == sum(range(1, world + 1))).all())

    def broadcast():
        x = big.clone()
        dist.broadcast(x, 0)
        return bool((x == 1.0).all())

    def all_gather():
        xs = [torch.empty_like(big) for _ in range(world)]
        dist.all_gather(xs, big)
        return all(bool((x == r + 1).all()) for r, x in enumerate(xs))

    def all_gather_into_tensor():
        x = torch.empty(world * big.numel(), device=dev)
        dist.all_gather_into_tensor(x, big)
        return all(bool((c == r + 1).all())
                   for r, c in enumerate(x.chunk(world)))

    for name, fn in (("all_reduce", all_reduce), ("broadcast", broadcast),
                     ("all_gather", all_gather),
                     ("all_gather_into_tensor", all_gather_into_tensor)):
        try:
            ok = fn()
            out[name] = {"ok": ok, "ms_12MiB": timed(fn)}
        except Exception as e:  # noqa: BLE001 - the probe reports any refusal
            out[name] = {"ok": False, "error": f"{type(e).__name__}: {e}"[:300]}
        dist.barrier()
    print(json.dumps(out), flush=True)
    dist.destroy_process_group()


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--rank", type=int)
    ap.add_argument("--port", type=int)
    args = ap.parse_args()
    if args.rank is not None:
        rank_main(args.rank, 2, args.port, args.device)
        return
    from dpt_tpu_torch.dist.launch import free_port, run_ranks

    if args.device == "cuda":
        print(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip(), flush=True)
    port = free_port()
    outs = run_ranks([[sys.executable, os.path.abspath(__file__),
                       "--device", args.device, "--rank", str(r), "--port",
                       str(port)] for r in range(2)], timeout=300)
    for text in outs:
        print(text.strip().splitlines()[-1], flush=True)


if __name__ == "__main__":
    main()
