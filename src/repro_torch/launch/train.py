"""End-to-end training driver.

  PYTHONPATH=src python -m repro_torch.launch.train --arch llama3.2-1b \\
      --steps 200 --seq 512 --batch 8 --ckpt-dir /tmp/ckpt [--smoke] \\
      [--device cpu] [--fsdp] [--remat {none,full,dots}]

Port of ``repro.launch.train``: the config system, the synthetic data
pipeline, the train step on a (data, model) mesh, checkpoint/restart
(resume is automatic if the checkpoint dir has a committed step), step
monitoring with straggler flagging, loss logging.  ``--smoke`` swaps in
the reduced config of the same family.  It runs on the card unless
``--device`` names another device.  Under ``torch.distributed`` (one
process a card, each with its own card set) every rank builds
``make_local_mesh(model=--model-parallel)`` and takes its rows of the
global batch; the replicas stay equal.  Every rank draws the model from
the seed with the sharded init (``models.model.init_sharded``): one
whole leaf at a time, keeping this rank's shards of it, so a card never
holds the whole model.  Under ``--model-parallel m > 1`` the leaves are
split over the model axis (``distributed/tensor_parallel.py``).
``--fsdp`` also splits the leaves and their moments over the data axis,
as the reference's training dry run does (``distributed/fsdp.py``); on a
data axis of one it changes nothing.  ``--remat``
recomputes each block in the backward (``full`` and ``dots`` alike);
the defaults, no FSDP and ``none``, are the reference driver's.  A
checkpoint holds whole leaves, whatever the mesh: every rank takes part
in gathering them, the first rank writes, and a restore slices them to
this rank's shards.  One JSON line a logged step, then ``TRAINING
DONE``.
"""
from __future__ import annotations

import argparse
import importlib
import json
import sys
import time

import torch

from repro_torch.config import ParallelConfig, TrainConfig, get_config
from repro_torch.distributed import sharding
from repro_torch.distributed import tensor_parallel as tpm
from repro_torch.distributed.elastic import StepMonitor, run_step_resilient
from repro_torch.launch.mesh import make_local_mesh
from repro_torch.models import model as M
from repro_torch.training import checkpoint as ckpt
from repro_torch.training import data as data_mod
from repro_torch.training import optimizer as opt
from repro_torch.training import train_step as ts

SMOKE_MODULES = {
    "jamba-v0.1-52b": "jamba_v01_52b", "stablelm-1.6b": "stablelm_1_6b",
    "llama3.2-1b": "llama32_1b", "qwen3-1.7b": "qwen3_1_7b",
    "qwen3-4b": "qwen3_4b", "qwen2-vl-72b": "qwen2_vl_72b",
    "mamba2-1.3b": "mamba2_1_3b",
    "deepseek-v2-lite-16b": "deepseek_v2_lite_16b",
    "phi3.5-moe-42b-a6.6b": "phi35_moe_42b",
    "hubert-xlarge": "hubert_xlarge",
}


def resolve_config(arch: str, smoke: bool):
    if smoke:
        mod = importlib.import_module("repro_torch.configs."
                                      + SMOKE_MODULES[arch])
        return mod.reduced()
    return get_config(arch)


def train_tree(model, opt_state):
    """The checkpointed tree: ``{"params": {name: tensor}, "opt":
    opt_state}``."""
    return {"params": dict(model.named_parameters()), "opt": opt_state}


@torch.no_grad()
def load_tree(model, opt_state, tree) -> None:
    """Copy a restored :func:`train_tree` (tensors or arrays) into
    ``model`` and ``opt_state`` in place; whole leaves are sliced to the
    shards the model holds over both axes."""
    tsize, trank = getattr(model, "tp_shards", None) or (1, 0)
    fsize, frank = getattr(model, "fsdp_shards", None) or (1, 0)
    dims = {n: (tpm.shard_dim(p), tpm.fsdp_dim(p))
            for n, p in model.named_parameters()}

    def part(name, v, like):
        v = torch.as_tensor(v)
        td, fd = dims[name]
        if td is not None:
            v = tpm.local_part(v, td, trank, tsize)
        if fd is not None:
            v = tpm.local_part(v, fd, frank, fsize)
        return v
    for name, p in model.named_parameters():
        p.copy_(part(name, tree["params"][name], p))
    for key in ("mu", "nu"):
        for name, v in opt_state[key].items():
            v.copy_(part(name, tree["opt"][key][name], v))
    step = torch.as_tensor(tree["opt"]["step"])
    opt_state["step"] = step.to(opt_state["step"].device,
                                opt_state["step"].dtype).clone()


def _barrier(mesh) -> None:
    if mesh.group is not None and mesh.size > 1:
        import torch.distributed as dist
        dist.barrier(group=mesh.group)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3.2-1b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--seq", type=int, default=512)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--model-parallel", type=int, default=1)
    ap.add_argument("--microbatch", type=int, default=0)
    ap.add_argument("--fsdp", action="store_true",
                    help="split leaves and moments over the data axis")
    ap.add_argument("--remat", default="none",
                    choices=("none", "full", "dots"))
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--log-file", default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)

    cfg = resolve_config(args.arch, args.smoke)
    mesh = make_local_mesh(model=args.model_parallel, device=args.device)
    dev = mesh.device
    sharding.set_mesh(mesh)
    pcfg = ParallelConfig(remat=args.remat, compute_dtype="float32",
                          param_dtype="float32")
    tcfg = TrainConfig(seq_len=args.seq, global_batch=args.batch,
                       lr=args.lr, steps=args.steps,
                       microbatch=args.microbatch, seed=args.seed)

    gen = torch.Generator(device=dev).manual_seed(args.seed)
    model = M.init_sharded(cfg, pcfg, gen, mesh, fsdp=args.fsdp, device=dev)
    opt_state = opt.init_opt_state(model)

    def restore(step):
        load_tree(model, opt_state, ckpt.restore(
            args.ckpt_dir, step, tpm.full_shapes(model, opt_state)))

    step0 = 0
    if args.ckpt_dir:
        last = ckpt.latest_step(args.ckpt_dir)
        if last is not None:
            restore(last)
            step0 = last
            print(f"resumed from step {step0}")

    _, shardings_for, jit_step = ts.make_train_step(cfg, pcfg, tcfg, mesh)
    psh, osh = shardings_for(model)
    fn = jit_step(psh, osh, None)

    pipe = data_mod.SyntheticLM(cfg.vocab, args.seq, args.batch,
                                seed=args.seed)
    lo, hi = ts.data_rows(mesh, args.batch)
    mon = StepMonitor(on_straggler=lambda s, t, m: print(
        f"[straggler] step {s}: {t:.2f}s vs median {m:.2f}s"))
    logf = open(args.log_file, "a") if args.log_file else None

    def make_batch(step):
        b = pipe.batch(step, lo, hi)
        if not cfg.embed_inputs:
            eb = data_mod.embeds_batch(step, args.batch, args.seq,
                                       cfg.d_model,
                                       pos3=(cfg.pos_dims == 3))
            b = dict({k: v[lo:hi] for k, v in eb.items()},
                     labels=b["labels"])
        return {k: torch.as_tensor(v).to(dev) for k, v in b.items()}

    def restore_latest():
        restore(ckpt.latest_step(args.ckpt_dir))
        return model, opt_state, batch

    def save(step):
        first = mesh.coords == (0,) * len(mesh.coords)
        tree = tpm.full_tree(model, opt_state, mesh, keep=first)
        if first:
            ckpt.save(args.ckpt_dir, step, tree)
        del tree
        _barrier(mesh)

    t_start = time.time()
    try:
        for step in range(step0, args.steps):
            batch = make_batch(step)

            def do(m, o, b, step=step):
                return mon.timed(step, fn, m, o, b)

            if args.ckpt_dir:
                metrics = run_step_resilient(do, None, restore_latest,
                                             model, opt_state, batch)
            else:
                metrics = do(model, opt_state, batch)

            if step % args.log_every == 0 or step == args.steps - 1:
                rec = dict(step=step, loss=float(metrics["loss"]),
                           grad_norm=float(metrics["grad_norm"]),
                           lr=float(metrics["lr"]),
                           elapsed=round(time.time() - t_start, 1))
                print(json.dumps(rec), flush=True)
                if logf:
                    logf.write(json.dumps(rec) + "\n")
                    logf.flush()
            if args.ckpt_dir and (step + 1) % args.ckpt_every == 0:
                save(step + 1)
        if args.ckpt_dir:
            save(args.steps)
    finally:
        if logf:
            logf.close()
        sharding.set_mesh(None)
    print("TRAINING DONE")
    return 0


if __name__ == "__main__":
    sys.exit(main())
