"""Batched serving driver: prefill a stream of prompt batches, decode.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3.2-1b \
      --smoke --batches 3 --batch 4 --prompt-len 16 --gen 16 [--device cpu]

Port of ``repro.launch.serve``: request batching, prefill+decode split,
per-step latency stats, straggler monitoring, on one device (the card
unless ``--device`` names another).  One JSON line a batch, then
``SERVING DONE``.
"""
from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from repro_torch.config import ParallelConfig
from repro_torch.core import device as _device
from repro_torch.distributed.elastic import StepMonitor
from repro_torch.launch.train import resolve_config
from repro_torch.models import model as M
from repro_torch.serving import decode


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3.2-1b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batches", type=int, default=2)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)

    cfg = resolve_config(args.arch, args.smoke)
    dev = _device.resolve(args.device)
    # The reference installs a local device mesh here (make_local_mesh,
    # set_mesh).  On one card the mesh places and shards nothing, and
    # launch/mesh.py is not ported yet, so there is no counterpart.
    pcfg = ParallelConfig(compute_dtype="float32")
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    model = M.init_params(cfg, gen, device=dev)
    rng = np.random.default_rng(args.seed)
    mon = StepMonitor()

    for b in range(args.batches):
        prompts = torch.as_tensor(
            rng.integers(0, cfg.vocab, (args.batch, args.prompt_len)),
            dtype=torch.long, device=dev)
        t0 = time.perf_counter()
        logits, cache = decode.prefill(cfg, pcfg, model,
                                       {"tokens": prompts})
        _sync(dev)
        t_prefill = time.perf_counter() - t0
        cache = decode.extend_cache(cache, args.gen)
        tok = logits[:, -1].argmax(-1)
        lat = []
        for i in range(args.gen - 1):
            t0 = time.perf_counter()
            logits, cache = decode.decode_step(
                cfg, pcfg, model, {"tokens": tok[:, None]}, cache)
            _sync(dev)
            lat.append(time.perf_counter() - t0)
            mon.observe(b * args.gen + i, lat[-1])
            tok = logits[:, -1].argmax(-1)
        print(json.dumps(dict(
            batch=b, prefill_s=round(t_prefill, 4),
            decode_p50_ms=round(float(np.median(lat)) * 1e3, 2),
            decode_p99_ms=round(float(np.quantile(lat, 0.99)) * 1e3, 2),
            tokens=args.batch * args.gen)))
    print("SERVING DONE")
    return 0


if __name__ == "__main__":
    sys.exit(main())
