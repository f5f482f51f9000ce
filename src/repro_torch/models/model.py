"""The model facade — the counterpart of ``repro.models.Model``: ``init``,
``loss_fn``, ``make_train_step``, ``example_batch``, ``init_cache``,
``make_decode_step`` and ``decode_cache_len``.

``Model(cfg, key)`` holds the parameters that the reference's
``Model(cfg).init(key)`` returns, drawn from the same keys in the same
``(in, out)`` layout, as an ``nn.Module``; ``Model(cfg)`` (no key) leaves
them uninitialised for :meth:`Model.load_param_tree` (and
:func:`repro_torch.convert.from_jax_model_params`). :meth:`Model.param_tree`
gives them in the reference's pytree layout, the cycle's parameters
stacked over cycles; the training step hands the optimizer that tree, so
that every optimizer, Adafactor's factoring and clipping included, sees
what the reference's sees, and its state is the reference's tree (a
checkpoint of either package resumes in the other).
:meth:`Model.decode_step` is the function ``make_decode_step()`` returns,
with the parameters bound; it takes no gradient.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from repro_torch import prng
from repro_torch.configs.base import ModelConfig
from repro_torch.configs.shapes import InputShape
from repro_torch.device import resolve_device
from repro_torch.models import loops
from repro_torch.models import transformer as tf
from repro_torch.models.layers import RMSNorm, dense_param, embed_init, frozen, lm_loss
from repro_torch.optim import Optimizer
from repro_torch.sharding import ctx as shctx
from repro_torch.tree import tree_map

# An RMSNorm's parameter is its ``scale``; the reference's tree holds the
# array itself under the norm's name.
_SCALE = ".scale"


class Model(nn.Module):
    """``embed`` ``(Vp, d)``, ``layers`` (prefix, then cycle by cycle),
    ``final_norm``, ``lm_head`` ``(d, Vp)`` unless embeddings are tied, and
    for an encoder-decoder ``enc`` (:class:`~repro_torch.models.transformer
    .Encoder`). ``init_model``'s keys: ``split(key, 6)`` — embed from [0],
    the stack from [1], lm_head from [2], the encoder from [3]. ``device``:
    the GPU unless given (``"cpu"``, or ``"meta"`` for shapes alone)."""

    def __init__(self, cfg: ModelConfig, key=None, device=None):
        super().__init__()
        device = resolve_device(device)
        self.cfg = cfg
        dt = getattr(torch, cfg.dtype)
        Vp, d = cfg.padded_vocab, cfg.d_model
        ks = prng.split(key, 6) if key is not None else (None,) * 6
        self.embed = frozen(embed_init(ks[0], Vp, d, dt, device) if key is not None else
                            torch.empty((Vp, d), dtype=dt, device=device))
        self.layers = tf.build_layers(ks[1], cfg, cfg.prefix_codes, cfg.cycle_codes,
                                      cfg.resolved_num_cycles, device)
        self.final_norm = RMSNorm(d, cfg.norm_eps, dt, device)
        self.register_parameter(
            "lm_head", None if cfg.tie_embeddings else dense_param(ks[2], d, Vp, dt, device))
        self.enc = tf.Encoder(ks[3], cfg, device) if cfg.encoder_layers else None

    @property
    def head(self) -> torch.Tensor:
        return self.embed.T if self.cfg.tie_embeddings else self.lm_head

    # ------------------------------------------------------ the reference's tree
    def _norms(self) -> set:
        """The names of the RMSNorm modules: the reference's tree holds each
        one's scale under the module's own name (``layers.3.norm2`` ↔
        ``…/norm2``). A mixer's raw ``norm`` array (sLSTM, mLSTM) is a
        parameter, not a module, and keeps its name."""
        return {n for n, m in self.named_modules() if isinstance(m, RMSNorm)}

    def param_tree(self, values: dict | None = None) -> dict:
        """The reference's parameter pytree of this model's parameters, or of
        ``values`` (parameter name → tensor, e.g. their gradients): ``embed``,
        ``final_norm``, ``lm_head`` unless tied, ``stack`` = ``{"prefix": [a
        tree per prefix layer], "cycle": {str(j): the tree of cycle position
        j, each leaf stacked over the cycles (a copy)} or None}``, and for an
        encoder-decoder ``enc`` = ``{"stack": the same for the encoder,
        "final_norm"}``."""
        values = dict(self.named_parameters()) if values is None else values
        norms = self._norms()
        nested: dict = {}
        for name, v in values.items():
            if name.endswith(_SCALE) and name[:-len(_SCALE)] in norms:
                name = name[:-len(_SCALE)]
            *path, leaf = name.split(".")
            node = nested
            for part in path:
                node = node.setdefault(part, {})
            node[leaf] = v
        cfg = self.cfg
        tree = {k: nested[k] for k in ("embed", "final_norm", "lm_head") if k in nested}
        tree["stack"] = _stack_tree([nested["layers"][str(i)] for i in range(len(self.layers))],
                                    len(cfg.prefix_codes), len(cfg.cycle_codes),
                                    cfg.resolved_num_cycles)
        if self.enc is not None:
            enc = nested["enc"]
            tree["enc"] = {"stack": _stack_tree([enc["layers"][str(i)]
                                                 for i in range(cfg.encoder_layers)],
                                                0, 1, cfg.encoder_layers),
                           "final_norm": enc["final_norm"]}
        return tree

    def param_paths(self) -> dict:
        """Each parameter's path in :meth:`param_tree` (keys, list indices
        as strings): ``layers.{i}.…`` lies under ``("stack", "prefix",
        str(i))`` or, in the cycle, ``("stack", "cycle", str(j))`` with its
        leaf stacked over the cycles; the encoder's layers under ``("enc",
        "stack", "cycle", "0")``. A norm's ``.scale`` is the norm's name."""
        cfg = self.cfg
        n_prefix, n_cycle = len(cfg.prefix_codes), len(cfg.cycle_codes)
        norms = self._norms()
        out = {}
        for name, _ in self.named_parameters():
            key = name
            if name.endswith(_SCALE) and name[:-len(_SCALE)] in norms:
                key = name[:-len(_SCALE)]
            parts = key.split(".")
            if parts[0] == "layers":
                i = int(parts[1])
                where = (("prefix", str(i)) if i < n_prefix else
                         ("cycle", str((i - n_prefix) % n_cycle)))
                parts = ["stack", *where, *parts[2:]]
            elif parts[:2] == ["enc", "layers"]:
                parts = ["enc", "stack", "cycle", "0", *parts[3:]]
            out[name] = tuple(parts)
        return out

    def param_specs(self, mesh, fsdp: bool = True) -> dict:
        """Each parameter's partition spec on ``mesh``
        (:func:`repro_torch.sharding.rules.param_spec`): a cycle layer's
        parameter takes its stacked leaf's spec without the leading
        ``None``."""
        from repro_torch.sharding.rules import param_spec

        out = {}
        for name, path in self.param_paths().items():
            shape = tuple(self.get_parameter(name).shape)
            if "cycle" in path:
                out[name] = param_spec(path, (1,) + shape, mesh, fsdp=fsdp)[1:]
            else:
                out[name] = param_spec(path, shape, mesh, fsdp=fsdp)
        return out

    def set_params(self, values: dict) -> "Model":
        """Replace parameters by new tensors (``name → tensor``: DTensors, say),
        each keeping its ``requires_grad``."""
        for name, t in values.items():
            mod_name, _, leaf = name.rpartition(".")
            mod = self.get_submodule(mod_name) if mod_name else self
            old = mod._parameters[leaf]
            mod._parameters[leaf] = nn.Parameter(t, requires_grad=old.requires_grad)
        return self

    def load_param_tree(self, tree: dict) -> "Model":
        """Copy a tree in the reference's layout (numpy arrays or tensors,
        cast to the parameters' dtype and device) into the parameters.
        Raises ``ValueError`` if a parameter of either side has no
        counterpart or another shape. Returns the model."""
        cfg = self.cfg
        flat = _flatten({k: tree[k] for k in ("embed", "final_norm", "lm_head") if k in tree})
        for i, lt in enumerate(_layer_trees(tree["stack"], cfg.resolved_num_cycles,
                                            len(cfg.cycle_codes))):
            flat.update(_flatten(lt, f"layers.{i}."))
        if "enc" in tree:
            for i, lt in enumerate(_layer_trees(tree["enc"]["stack"], cfg.encoder_layers, 1)):
                flat.update(_flatten(lt, f"enc.layers.{i}."))
            flat.update(_flatten({"final_norm": tree["enc"]["final_norm"]}, "enc."))
        norms = self._norms()
        flat = {(k + _SCALE if k in norms else k): v for k, v in flat.items()}
        ours = dict(self.named_parameters())
        if set(flat) != set(ours):
            raise ValueError(f"parameters differ: only in the reference's tree "
                             f"{sorted(set(flat) - set(ours))}, only in the port's "
                             f"{sorted(set(ours) - set(flat))}")
        with torch.no_grad():
            for name, p in ours.items():
                src = flat[name]
                if not isinstance(src, torch.Tensor):
                    src = torch.tensor(np.asarray(src))
                if tuple(src.shape) != tuple(p.shape):
                    raise ValueError(f"{name}: shape {tuple(src.shape)} != {tuple(p.shape)}")
                p.copy_(src)
        return self

    # ------------------------------------------------------------ training
    def forward_logits(self, batch: dict, routes: list | None = None):
        """(logits (B, S, Vp), aux loss, loss mask (B, S)):
        :func:`repro_torch.models.transformer.forward_logits`."""
        return tf.forward_logits(self, batch, routes)

    def loss_fn(self, batch: dict) -> torch.Tensor:
        """The next-token loss on the batch's ``labels`` (B, S) (plus its
        ``tokens`` and, by the model, ``patch_embeds`` or ``frames``), and
        for an MoE model ``cfg.moe.aux_weight`` times the aux loss."""
        logits, aux, mask = self.forward_logits(batch)
        labels = batch["labels"]
        S_lab = labels.shape[1]
        # Logits cover the full (possibly frontend-extended) sequence;
        # labels cover the text positions: take the tail, then shift.
        logits = logits[:, -S_lab:]
        mask = mask[:, -S_lab:]
        loss = lm_loss(logits[:, :-1], labels[:, 1:], mask[:, 1:])
        if self.cfg.moe is not None:
            loss = loss + self.cfg.moe.aux_weight * aux
        return loss

    def make_train_step(self, optimizer: Optimizer, microbatches: int = 1):
        """Turn the parameters' gradients on and return ``train_step(opt_state,
        batch, step) -> (opt_state, loss)``, which updates the parameters in
        place. With ``microbatches > 1`` the batch is cut into that many
        chunks along its first axis; each chunk's loss and float32 gradients
        are summed from zero, then divided by the count (the reference's
        ``lax.scan``). The optimizer gets the gradients and parameters as
        :meth:`param_tree` lays them out, and ``step`` (an int) as is."""
        self.requires_grad_(True)
        names, params = zip(*self.named_parameters())

        def value_and_grad(batch):
            loss = self.loss_fn(batch)
            return loss.detach(), torch.autograd.grad(loss, params)

        def train_step(opt_state, batch, step):
            if microbatches == 1:
                loss, grads = value_and_grad(batch)
            else:
                B = batch["tokens"].shape[0]
                if B % microbatches:
                    raise ValueError(f"batch {B} does not split into {microbatches} "
                                     f"microbatches")
                split = {k: shctx.split_microbatches(v, microbatches) for k, v in batch.items()}

                def trip(carry, i):
                    # each chunk's batch back on the batch axes (the identity
                    # without a mesh context), as GSPMD keeps the reference's
                    loss, grads = carry
                    l, g = value_and_grad({k: shctx.shard_batch(v[i]) for k, v in split.items()})
                    return (loss + l, [a + b for a, b in zip(grads, g)]), None

                box = [(torch.zeros((), dtype=torch.float32, device=self.embed.device),
                        [torch.zeros_like(p, dtype=torch.float32) for p in params])]
                (loss, grads), _ = loops.trips(trip, box, microbatches)
                loss = loss / microbatches
                grads = [g / microbatches for g in grads]
            with torch.no_grad():
                new_params, opt_state = optimizer.update(
                    self.param_tree(dict(zip(names, grads))), opt_state, self.param_tree(),
                    step)
                self.load_param_tree(new_params)
            return opt_state, loss

        return train_step

    def example_batch(self, shape: InputShape, key=None, concrete: bool = True) -> dict:
        """Inputs of ``shape``'s kind on the model's device, drawn as the
        reference's are (``randint`` from ``key``, default ``PRNGKey(0)``;
        tokens and labels from the same key; frames and patches zeros):
        ``train`` ``{"tokens", "labels"}`` (B, S), with ``frames`` (B, S, d)
        and B × max(S // 4, 8) tokens for an encoder-decoder,
        ``patch_embeds`` (B, P, d) and S − P tokens for vision; ``prefill``
        the same without labels; the decode kinds ``{"token" (B, 1), "pos":
        S − 1}`` (an int, as :meth:`decode_step` takes it). With
        ``concrete=False`` (the dry run's) the tensors are left unwritten
        (``torch.empty``; on a ``meta`` model, shapes and dtypes alone)."""
        cfg = self.cfg
        B, S = shape.global_batch, shape.seq_len
        key = key if key is not None else prng.PRNGKey(0)
        V, dev = cfg.vocab_size, self.embed.device
        dt = getattr(torch, cfg.dtype)

        def toks(shape_):
            if not concrete:
                return torch.empty(shape_, dtype=torch.int32, device=dev)
            return prng.randint(key, shape_, 0, V, dev)

        def dense(shape_):
            return (torch.zeros if concrete else torch.empty)(shape_, dtype=dt, device=dev)

        if shape.kind in ("train", "prefill"):
            labels = shape.kind == "train"
            if cfg.encoder_layers:
                S_dec = max(S // 4, 8)
                out = {"frames": dense((B, S, cfg.d_model)), "tokens": toks((B, S_dec))}
                S_lab = S_dec
            elif cfg.frontend == "vision":
                P = cfg.frontend_tokens
                out = {"tokens": toks((B, S - P)), "patch_embeds": dense((B, P, cfg.d_model))}
                S_lab = S - P
            else:
                out, S_lab = {"tokens": toks((B, S))}, S
            if labels:
                out["labels"] = toks((B, S_lab))
            return out
        return {"token": toks((B, 1)), "pos": S - 1}

    # ------------------------------------------------------------- serving
    def init_cache(self, batch: int, cache_len: int, enc_len: int | None = None) -> list:
        return tf.init_cache(self.cfg, batch, cache_len, enc_len, self.embed.device)

    def decode_step(self, cache: list, token: torch.Tensor, pos: int, *,
                    swa_kernel: bool = True, routes: list | None = None):
        """token (B, 1) int on the model's device; ``pos`` a Python int.
        Returns (logits (B, 1, Vp), cache), the cache updated in place.
        ``swa_kernel=False`` runs full rings through the plain masked
        attention instead of K7; ``routes`` (a list) gets each MoE layer's
        routes. No gradient is taken, trainable or not."""
        with torch.no_grad():
            return tf.decode_step(self, cache, token, pos, swa_kernel=swa_kernel,
                                  routes=routes)

    def prefill_encoder(self, frames: torch.Tensor, cache: list) -> list:
        """An encoder-decoder's encoder on ``frames`` (B, Se, d), its cross
        K/V put into the cache of every ``C`` layer (no gradient)."""
        with torch.no_grad():
            return tf.prefill_encoder(self, frames, cache)

    def decode_cache_len(self, shape: InputShape) -> int:
        cfg = self.cfg
        if cfg.attention_window is not None:
            return min(shape.seq_len, cfg.attention_window)
        return shape.seq_len


def _stack_tree(layers: list, n_prefix: int, n_cycle: int, n_cycles: int) -> dict:
    """Per-layer trees in layer order → ``{"prefix": [...], "cycle": {str(j):
    position j's leaves stacked over the cycles} or None}``."""
    cycle = None
    if n_cycles:
        cycle = {str(j): tree_map(lambda *ls: torch.stack(ls),
                                  *[layers[n_prefix + c * n_cycle + j] for c in range(n_cycles)])
                 for j in range(n_cycle)}
    return {"prefix": layers[:n_prefix], "cycle": cycle}


def _layer_trees(stack: dict, n_cycles: int, n_cycle: int) -> list:
    """The reference's per-layer parameter trees of a ``stack`` in layer
    order: prefix layers, then cycle c's position j (``[c]`` of the stacked
    cycle leaves) at ``len(prefix) + c·n_cycle + j``."""
    layers = list(stack["prefix"])
    if stack["cycle"] is not None:
        for c in range(n_cycles):
            for j in range(n_cycle):
                layers.append(tree_map(lambda a, c=c: a[c], stack["cycle"][str(j)]))
    return layers


def _flatten(tree: dict, prefix: str = "") -> dict:
    """A reference tree → ``{dotted path: leaf}``."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flatten(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = v
    return out
