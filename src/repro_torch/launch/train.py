"""The training driver, the counterpart of ``repro.launch.train``: train
a backbone of the zoo, by default yi-6b scaled to d_model 512 and 8 layers
(30.4 M parameters, ``scaled_config``), for N steps on the card.

Fault tolerance: asynchronous checkpoints every ``--ckpt-every`` steps
and a blocking one at the end; a run started again with the same
``--ckpt`` resumes from the newest complete checkpoint (parameters,
optimizer state and the data stream's cursor), so a run killed mid-way
ends on the same bits as one that was not.  On the card the driver makes
PyTorch's ops deterministic (``torch.use_deterministic_algorithms``, with
``CUBLAS_WORKSPACE_CONFIG`` set before CUDA starts; an op with no
deterministic form raises, so a step that could not repeat its bits does
not run); the CUDA kernels use no atomics.

``--flags`` turns on ``PerfFlags`` by name, comma-separated, as the
reference's dry run takes them: ``bf16_params`` (bfloat16 parameters, the
optimizer's float32 master in the checkpoints too) and ``pad_vocab``.

  PYTHONPATH=src python -m repro_torch.launch.train --steps 200 \\
      --d-model 512 --layers 8 --seq 256 --batch 16 --ckpt build/run1
  PYTHONPATH=src python -m repro_torch.launch.train --device cpu --smoke --steps 20
  PYTHONPATH=src python -m repro_torch.launch.train --flags bf16_params,pad_vocab

Prints the reference driver's lines: the config, then ``step``, ``loss``,
``lr`` and ``gnorm`` at step 1 and every 10 steps (the only host syncs of
the loop), then ``done``.  A Mamba1 model (``--arch falcon_mamba_7b``)
trains on the CPU only: on the card the scan kernel has no backward yet
and its wrapper refuses.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import time

import numpy as np
import torch

from repro_torch import tree as T
from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.data import SyntheticLMStream
from repro_torch.device import resolve_device
from repro_torch.launch.steps import build_train_step, init_train_params
from repro_torch.models.config import ModelConfig
from repro_torch.optim import OptConfig, init_opt_state
from repro_torch.perf import PerfFlags, get_flags, perf_flags


def scaled_config(arch: str, d_model: int, layers: int) -> ModelConfig:
    """A small variant of an architecture family, as the reference's:
    ``d_model`` wide over ``d_model // 128`` heads (at least 4), ``layers``
    deep, an 8,192-token vocab (yi-6b at 512 and 8: 30,351,872
    parameters)."""
    base = get_config(arch)
    heads = max(4, d_model // 128)
    kv = max(1, heads * base.num_kv_heads // max(base.num_heads, 1)) \
        if base.num_heads else 0
    kw = dict(num_layers=layers, d_model=d_model, vocab_size=8192,
              remat=False)
    if base.num_heads:
        kw.update(num_heads=heads, num_kv_heads=max(1, kv),
                  head_dim=d_model // heads,
                  d_ff=int(d_model * 8 / 3) // 16 * 16)
    if base.family == "moe":
        kw.update(num_experts=8, experts_per_token=2,
                  d_ff=int(d_model * 2) // 16 * 16)
    if base.family == "hybrid":
        kw.update(attn_every=max(2, layers // 3), ssm_head_dim=32)
    if base.family == "audio":
        kw.update(encoder_layers=max(2, layers // 2), encoder_seq=128)
    return dataclasses.replace(base, **kw)


def _deterministic(dev: torch.device) -> None:
    """Deterministic PyTorch ops on the card: cuBLAS's workspace fixed
    before its first handle, then ``use_deterministic_algorithms`` (the
    embedding's and the gold logit's backward then accumulate in a fixed
    order; an op with no deterministic CUDA form raises)."""
    if dev.type == "cuda":
        os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
        torch.use_deterministic_algorithms(True)


def _to_device(tree, dev: torch.device):
    return T.tree_map(lambda a: torch.as_tensor(a).to(dev), tree)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="yi_6b")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--d-model", type=int, default=512)
    ap.add_argument("--layers", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced smoke config instead of "
                         "--d-model/--layers")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--flags", default="",
                    help="PerfFlags to turn on, comma-separated: "
                         "bf16_params, pad_vocab")
    args = ap.parse_args(argv)
    names = [f for f in args.flags.split(",") if f]
    known = {f.name for f in dataclasses.fields(PerfFlags)}
    if set(names) - known:
        ap.error(f"--flags: {sorted(set(names) - known)} not among "
                 f"{sorted(known)}")
    flags = dataclasses.replace(get_flags(), **{f: True for f in names})
    dev = resolve_device(args.device)
    _deterministic(dev)

    cfg = (get_smoke_config(args.arch) if args.smoke
           else scaled_config(args.arch, args.d_model, args.layers))
    n_params = cfg.param_count()
    print(f"arch={cfg.name} family={cfg.family} params~{n_params/1e6:.1f}M")

    opt_cfg = OptConfig(lr=args.lr, warmup_steps=20, total_steps=args.steps)
    stream = SyntheticLMStream(cfg.vocab_size, args.seq, args.batch, seed=0)
    with perf_flags(flags):
        step_fn = build_train_step(cfg, opt_cfg, device=dev)
    params = init_train_params(step_fn.cfg, 0, device=dev)
    opt_state = init_opt_state(params, master_weights=flags.bf16_params)

    start = 0
    mgr = CheckpointManager(args.ckpt) if args.ckpt else None
    if mgr is not None:
        try:
            start, payload = mgr.restore_latest()
            params = _to_device(payload["params"], dev)
            opt_state = _to_device(payload["opt"], dev)
            stream.load_state_dict(payload["stream"])
            print(f"resumed from step {start}")
        except FileNotFoundError:
            pass

    t0 = time.time()
    for step in range(start + 1, args.steps + 1):
        batch = stream.next_batch()
        if cfg.family == "audio":
            rng = np.random.default_rng(step)
            batch["frames"] = rng.standard_normal(
                (args.batch, cfg.encoder_seq, cfg.d_model)).astype(
                    np.float32) * 0.2
        params, opt_state, metrics = step_fn(params, opt_state, batch)
        if step % 10 == 0 or step == 1:
            loss = float(metrics["loss"])
            print(f"step {step:5d}  loss {loss:7.4f}  "
                  f"lr {float(metrics['lr']):.2e}  "
                  f"gnorm {float(metrics['grad_norm']):7.3f}  "
                  f"{(time.time()-t0):6.1f}s", flush=True)
        if mgr is not None and step % args.ckpt_every == 0:
            mgr.save(step, {"params": params, "opt": opt_state,
                            "stream": stream.state_dict()})
    if mgr is not None:
        mgr.save(args.steps, {"params": params, "opt": opt_state,
                              "stream": stream.state_dict()}, blocking=True)
    print("done")


if __name__ == "__main__":
    main()
