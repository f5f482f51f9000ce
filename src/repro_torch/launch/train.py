"""Transformer training launcher: ``--arch <id>`` from the registry — the
port of ``repro.launch.train`` (seed scaffolding, see
``docs/SEED_SCAFFOLDING.md``).

It runs on the GPU unless ``device="cpu"`` is passed. With ``mesh=`` (a
``DeviceMesh`` with the reference's axis names: :func:`repro_torch.launch
.mesh.make_smoke_mesh`, or a cluster's :func:`~repro_torch.launch.mesh
.make_production_mesh`) the parameters, the optimizer state and each batch
are DTensors placed by :mod:`repro_torch.sharding.rules`, and the run goes
under :func:`repro_torch.sharding.ctx.use_mesh_constraints`, as the
reference's; on a 1 × 1 mesh it gives the mesh-less run's losses.
Checkpoints are the reference's: ``{"params":
<its parameter tree>, "opt": <its optimizer-state tree>}`` at
``<ckpt-dir>/step_<N>.npz``, so either package resumes the other's. As the
reference's, a resumed run restarts the token stream from its first batch
(only the step count, and with it the optimizer's bias corrections,
carries on).

  PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-360m \\
      --reduced --steps 100 --batch 8 --seq 64 --ckpt-dir /tmp/ckpt --device cpu
"""

from __future__ import annotations

import argparse
import contextlib
import time

import numpy as np
import torch

from repro_torch import prng
from repro_torch.checkpoint import latest_step_path, load_checkpoint, save_checkpoint
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.data.corpus import SemanticCorpusModel
from repro_torch.device import resolve_device
from repro_torch.models import Model
from repro_torch.optim import get_optimizer
from repro_torch.tree import tree_map


def synthetic_lm_batches(vocab: int, batch: int, seq: int, steps: int,
                         seed: int = 0):
    """LM token stream from the structured synthetic corpus model — real
    next-token signal, not uniform noise. Yields ``(batch, seq)`` int32
    numpy arrays, the reference's batches bitwise."""
    gen = SemanticCorpusModel.create(vocab_size=min(vocab, 4000), seed=seed)
    corpus = gen.generate(num_sentences=max(200, batch * steps // 2),
                          seed=seed + 1)
    toks = corpus.tokens
    need = batch * seq
    for i in range(steps):
        lo = (i * need) % max(len(toks) - need, 1)
        chunk = toks[lo : lo + need]
        if len(chunk) < need:
            chunk = np.tile(chunk, need // max(len(chunk), 1) + 1)[:need]
        yield (chunk.reshape(batch, seq) % vocab).astype(np.int32)


def lm_batch(cfg, toks: torch.Tensor, seq: int) -> dict:
    """The reference launcher's batch dict around ``toks`` (B, S): tokens
    and labels; for vision also ``cfg.frontend_tokens`` zero patch
    embeddings; for an encoder-decoder ``seq`` zero frames too."""
    batch = {"tokens": toks, "labels": toks}
    dt = getattr(torch, cfg.dtype)
    if cfg.frontend == "vision":
        batch["patch_embeds"] = torch.zeros((toks.shape[0], cfg.frontend_tokens, cfg.d_model),
                                            dtype=dt, device=toks.device)
    if cfg.encoder_layers:
        batch = {"frames": torch.zeros((toks.shape[0], seq, cfg.d_model), dtype=dt,
                                       device=toks.device),
                 "tokens": toks, "labels": toks}
    return batch


def _full(t):
    """A DTensor's whole value on every rank (a plain tensor as it is)."""
    return t.full_tensor() if hasattr(t, "full_tensor") else t


def _save(path: str, model: Model, opt_state, step: int) -> None:
    with torch.no_grad():
        save_checkpoint(path, tree_map(_full, {"params": model.param_tree(), "opt": opt_state}),
                        step=step)


def shard_for_training(model: Model, opt_state, mesh):
    """Place ``model``'s parameters and ``opt_state`` on ``mesh`` as
    DTensors (:func:`repro_torch.sharding.rules.tree_param_specs`; a cycle
    layer's parameter takes its stacked leaf's spec without the leading
    ``None``). Every rank must hold the same values (a seeded init):
    each keeps its own shard. Returns the placed optimizer state."""
    from torch.distributed.tensor import distribute_tensor

    from repro_torch.sharding.rules import to_placements, tree_param_specs, with_sharding

    fsdp = model.cfg.fsdp
    with torch.no_grad():
        model.set_params({
            name: distribute_tensor(model.get_parameter(name).data, mesh,
                                    to_placements(spec, mesh), src_data_rank=None)
            for name, spec in model.param_specs(mesh, fsdp).items()})
        return with_sharding(opt_state, tree_param_specs(opt_state, mesh, fsdp), mesh)


def train(arch: str, *, reduced: bool, steps: int, batch: int, seq: int,
          lr: float, ckpt_dir: str | None, ckpt_every: int, mesh=None,
          log_every: int = 10, resume: bool = False, device=None):
    """Train ``arch`` from ``PRNGKey(0)`` (or the latest checkpoint under
    ``ckpt_dir`` with ``resume``) with ``cfg.train_optimizer``, on ``mesh``
    if one is given (see the module doc). Returns ``(model, losses,
    opt_state)``: the trained model, the step losses as floats, and the
    optimizer state in the reference's tree (DTensors on a mesh)."""
    dev = resolve_device(device)
    # The default, set explicitly: TF32 matmuls would cost the training
    # step its parity with the reference.
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_config(arch)
    if reduced:
        cfg = cfg.reduced()
    model = Model(cfg, prng.PRNGKey(0), device=dev)
    opt = get_optimizer(cfg.train_optimizer, lr=lr)
    with torch.no_grad():
        opt_state = opt.init(model.param_tree())
    step0 = 0
    if resume and ckpt_dir:
        path = latest_step_path(ckpt_dir)
        if path:
            tree, meta = load_checkpoint(path)
            model.load_param_tree(tree["params"])
            opt_state = tree_map(
                lambda a, b: torch.tensor(np.asarray(b), dtype=a.dtype, device=a.device),
                opt_state, tree["opt"])
            step0 = int(meta.get("step") or 0)
            print(f"resumed from {path} @ step {step0}")

    run = contextlib.nullcontext()
    if mesh is not None:
        from repro_torch.sharding import ctx as shctx
        from repro_torch.sharding.rules import tree_data_specs, with_sharding

        opt_state = shard_for_training(model, opt_state, mesh)
        run = shctx.use_mesh_constraints(mesh)
    mb = 1 if reduced else cfg.train_microbatches
    step_fn = model.make_train_step(opt, microbatches=mb)
    t0 = time.perf_counter()
    losses = []
    stream = synthetic_lm_batches(cfg.vocab_size, batch, seq, steps)
    with run:
        for i, toks in enumerate(stream, start=step0):
            toks = torch.from_numpy(toks).to(dev)
            b = lm_batch(cfg, toks, seq)
            if mesh is not None:
                b = with_sharding(b, tree_data_specs(b, mesh), mesh)
            opt_state, loss = step_fn(opt_state, b, i)
            losses.append(float(_full(loss)))
            if (i + 1) % log_every == 0:
                dt = time.perf_counter() - t0
                tok_s = (i + 1 - step0) * toks.numel() / dt
                print(f"step {i+1:5d} loss {np.mean(losses[-log_every:]):.4f} "
                      f"({tok_s:.0f} tok/s)")
            if ckpt_dir and (i + 1) % ckpt_every == 0:
                _save(f"{ckpt_dir}/step_{i+1}.npz", model, opt_state, i + 1)
    if ckpt_dir:
        _save(f"{ckpt_dir}/step_{step0+steps}.npz", model, opt_state, step0 + steps)
    return model, losses, opt_state


def build_parser() -> argparse.ArgumentParser:
    """The reference's parser, plus ``--device``."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=ARCH_IDS)
    ap.add_argument("--reduced", action="store_true",
                    help="CPU-scale reduced config")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=200)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the current CUDA device)")
    return ap


def main(argv=None):
    args = build_parser().parse_args(argv)
    _, losses, _ = train(args.arch, reduced=args.reduced, steps=args.steps,
                         batch=args.batch, seq=args.seq, lr=args.lr,
                         ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every,
                         resume=args.resume, device=args.device)
    print(f"final loss {losses[-1]:.4f} (first {losses[0]:.4f})")


if __name__ == "__main__":
    main()
