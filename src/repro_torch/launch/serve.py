"""Batched serving driver: prefill a stream of prompt batches, decode.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3.2-1b \
      --smoke --batches 3 --batch 4 --prompt-len 16 --gen 16 [--device cpu]

Port of ``repro.launch.serve``: request batching, prefill+decode split,
per-step latency stats, straggler monitoring, on the local mesh
(``launch/mesh.py``) over the processes of ``torch.distributed``, one
card each (this process alone without it; the card unless ``--device``
names another).  ``--model-parallel m`` splits the mesh's model axis
over ``m`` ranks: the weights are drawn sharded (``init_sharded``; no
card holds the whole model) and the caches split as the reference's
serving cells place them (``seq_shard_decode``: each rank holds a block
of positions).  Each rank serves its rows of the batch
(``serving.decode.rows``).  One JSON line a batch (with each card's
memory peak on the card), then ``SERVING DONE``.
"""
from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from repro_torch.config import ParallelConfig
from repro_torch.distributed import sharding
from repro_torch.distributed.elastic import StepMonitor
from repro_torch.launch.mesh import make_local_mesh
from repro_torch.launch.train import resolve_config
from repro_torch.models import model as M
from repro_torch.serving import decode


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _peaks_gib(mesh, dev):
    """Each mesh rank's peak of allocated card memory (GiB), or None off
    the card."""
    if dev.type != "cuda":
        return None
    mine = torch.tensor([torch.cuda.max_memory_allocated(dev) / 2 ** 30],
                        device=dev)
    if mesh.group is None or mesh.size == 1:
        return [float(mine)]
    import torch.distributed as dist
    parts = [torch.empty_like(mine) for _ in range(mesh.size)]
    dist.all_gather(parts, mine, group=mesh.group)
    return [float(p) for p in parts]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3.2-1b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batches", type=int, default=2)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--model-parallel", type=int, default=1)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)

    cfg = resolve_config(args.arch, args.smoke)
    mesh = make_local_mesh(model=args.model_parallel, device=args.device)
    dev = mesh.device
    sharding.set_mesh(mesh)
    pcfg = ParallelConfig(compute_dtype="float32",
                          seq_shard_decode=args.model_parallel > 1)
    try:
        gen = torch.Generator(device=dev).manual_seed(args.seed)
        model = M.init_sharded(cfg, pcfg, gen, mesh, fsdp=False, device=dev)
        init_peaks = _peaks_gib(mesh, dev)
        lo, hi, group = decode.rows(mesh, pcfg, args.batch)
        rng = np.random.default_rng(args.seed)
        mon = StepMonitor()

        for b in range(args.batches):
            prompts = torch.as_tensor(
                rng.integers(0, cfg.vocab, (args.batch, args.prompt_len)),
                dtype=torch.long, device=dev)[lo:hi]
            t0 = time.perf_counter()
            logits, cache = decode.prefill(cfg, pcfg, model,
                                           {"tokens": prompts}, group)
            _sync(dev)
            t_prefill = time.perf_counter() - t0
            cache = decode.extend_cache(cache, args.gen, pcfg)
            tok = logits[:, -1].argmax(-1)
            lat = []
            for i in range(args.gen - 1):
                t0 = time.perf_counter()
                logits, cache = decode.decode_step(
                    cfg, pcfg, model, {"tokens": tok[:, None]}, cache, group)
                _sync(dev)
                lat.append(time.perf_counter() - t0)
                mon.observe(b * args.gen + i, lat[-1])
                tok = logits[:, -1].argmax(-1)
            rec = dict(
                batch=b, prefill_s=round(t_prefill, 4),
                decode_p50_ms=round(float(np.median(lat)) * 1e3, 2),
                decode_p99_ms=round(float(np.quantile(lat, 0.99)) * 1e3, 2),
                tokens=args.batch * args.gen)
            peaks = _peaks_gib(mesh, dev)
            if peaks is not None:
                rec.update(init_peak_gib=init_peaks, peak_gib=peaks)
            print(json.dumps(rec))
    finally:
        sharding.set_mesh(None)
    print("SERVING DONE")
    return 0


if __name__ == "__main__":
    sys.exit(main())
