"""Training launcher: one process on one device, any ported --arch config
(port of ``repro.launch.train``).

``--reduced`` runs the 2-layer family member in float32 (CPU-friendly);
without it the full config is used, on the card.  ``--dagafl N`` federates
N clients through the DAG-AFL coordinator instead of single-stream
training.  The reference's ``--pallas`` and ``--kernel-policy`` have no
counterpart: the device decides between a kernel and its plain version,
and ``--device`` (default: the CUDA card) names it.

    PYTHONPATH=src python -m repro_torch.launch.train --reduced --steps 2 \\
        --device cpu

The token streams are the reference's (``make_lm_dataset`` at the model's
vocabulary), whose vocab x vocab transition matrix takes 68.5 GB at
internlm2's 92,544 tokens; a caller at full width passes ``pipe=`` a
:class:`~repro_torch.data.pipeline.TokenPipeline` over a sub-vocabulary.
Likewise the reference's zero frame embeddings for an encoder make the
gradient overflow at whisper-medium's depth; a caller passes
``enc_embed=`` frames of its own.
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import torch

from repro_torch.configs import ARCH_IDS, get_config, reduced
from repro_torch.data.pipeline import TokenPipeline
from repro_torch.models import transformer as tfm
from repro_torch.runtime import Runtime, resolve_device
from repro_torch.train.checkpoint import save_checkpoint
from repro_torch.train.step import make_train_step


def train_single(cfg, args, pipe=None, history=None, enc_embed=None):
    """``args.steps`` AdamW steps of one model on one token stream; returns
    the trained parameters.  ``pipe`` replaces the default pipeline;
    ``history``, a list, receives each step's metrics as numbers and its
    seconds (each step then ends in a host copy).  A config with an
    encoder gets zero float32 frame embeddings (B, n_ctx, d) every step,
    as in the reference, unless ``enc_embed`` gives others: at
    whisper-medium's 24 encoder layers zero frames overflow the gradient
    (each layer norm of a zero row scales its backward by 1/sqrt(eps)),
    and the first step turns every parameter into NaN, in the reference
    as here."""
    device = resolve_device(args.device)
    step, opt = make_train_step(cfg, runtime=Runtime(want_signature=True))
    params = tfm.init_params(torch.Generator(device=device)
                             .manual_seed(args.seed), cfg)
    opt_state = opt.init(params)
    pipe = pipe or TokenPipeline(cfg.vocab_size, args.batch, args.seq,
                                 seed=args.seed)
    it = iter(pipe)
    t0 = time.time()
    for i in range(args.steps):
        t_step = time.perf_counter()
        batch = {k: torch.from_numpy(v).to(device)
                 for k, v in pipe.batch_dict(next(it)).items()}
        if cfg.encoder is not None:
            batch["enc_embed"] = enc_embed if enc_embed is not None \
                else torch.zeros((batch["tokens"].shape[0],
                                  cfg.encoder.n_ctx, cfg.d_model),
                                 dtype=torch.float32, device=device)
        params, opt_state, m = step(params, opt_state, batch)
        if history is not None:
            record = {k: (v.cpu().tolist() if v.dim() else float(v))
                      for k, v in m.items()}
            record["seconds"] = time.perf_counter() - t_step
            history.append(record)
        if i % args.log_every == 0 or i == args.steps - 1:
            # the step's kernels run asynchronously: read the clock after
            # the metrics have reached the host
            loss, gnorm = float(m["loss"]), float(m["grad_norm"])
            dt = time.time() - t0
            tok_s = pipe.batch * pipe.seq * (i + 1) / max(dt, 1e-9)
            print(f"step {i:5d} loss={loss:.4f} grad_norm={gnorm:.3f} "
                  f"tok/s={tok_s:,.0f}")
    if args.checkpoint:
        save_checkpoint(args.checkpoint, params, step=args.steps)
        print(f"saved {args.checkpoint}")
    return params


def train_dagafl(cfg, args):
    from repro_torch.core.coordinator import DagAflConfig, DagAflCoordinator
    from repro_torch.core.simulator import CostModel, make_profiles
    from repro_torch.data.synthetic import make_lm_dataset
    from repro_torch.fl.backend import LMBackend

    backend = LMBackend(cfg, lr=args.lr, local_steps=args.local_steps,
                        batch_size=args.batch, seq_len=args.seq,
                        device=args.device)
    streams = [make_lm_dataset(vocab=cfg.vocab_size, n_tokens=50_000,
                               order=1.5 + 0.5 * c, seed=c)
               for c in range(args.dagafl)]
    client_data = [{"train": s, "val": s, "test": s} for s in streams]
    global_test = make_lm_dataset(vocab=cfg.vocab_size, n_tokens=50_000,
                                  seed=999)
    dcfg = DagAflConfig(n_clients=args.dagafl, max_rounds=args.rounds,
                        local_epochs=args.local_steps, seed=args.seed)
    coord = DagAflCoordinator(backend, client_data, global_test, dcfg,
                              CostModel(), make_profiles(args.dagafl))
    res = coord.run()
    print(res.row())
    print("chain:", res.extra)
    return res


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", default="internlm2-1.8b", choices=ARCH_IDS)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--checkpoint", default="")
    ap.add_argument("--dagafl", type=int, default=0,
                    help="federate N clients via DAG-AFL")
    ap.add_argument("--rounds", type=int, default=5)
    ap.add_argument("--local-steps", type=int, default=8)
    return ap


def main(argv=None):
    args = parser().parse_args(argv)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = dataclasses.replace(reduced(cfg), compute_dtype="float32")
    print(f"arch={cfg.name} params≈{cfg.param_count()/1e6:.1f}M")
    if args.dagafl:
        train_dagafl(cfg, args)
    else:
        train_single(cfg, args)


if __name__ == "__main__":
    main()
