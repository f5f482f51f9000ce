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
from repro_torch.models import transformer as tf
from repro_torch.models.layers import RMSNorm, dense_param, embed_init, frozen, lm_loss
from repro_torch.optim import Optimizer
from repro_torch.tree import tree_map

# An RMSNorm's parameter is its ``scale``; the reference's tree holds the
# array itself under the norm's name.
_SCALE = ".scale"


class Model(nn.Module):
    """``embed`` ``(Vp, d)``, ``layers`` (prefix, then cycle by cycle),
    ``final_norm`` and, unless embeddings are tied, ``lm_head`` ``(d,
    Vp)``. ``init_model``'s keys: ``split(key, 6)`` — embed from [0], the
    stack from [1], lm_head from [2]. ``device``: the GPU unless given
    (``"cpu"``, or ``"meta"`` for shapes alone)."""

    def __init__(self, cfg: ModelConfig, key=None, device=None):
        super().__init__()
        tf.check_supported(cfg)
        device = resolve_device(device)
        self.cfg = cfg
        dt = getattr(torch, cfg.dtype)
        Vp, d = cfg.padded_vocab, cfg.d_model
        ks = prng.split(key, 6) if key is not None else (None,) * 6
        self.embed = frozen(embed_init(ks[0], Vp, d, dt, device) if key is not None else
                            torch.empty((Vp, d), dtype=dt, device=device))
        keys = tf.layer_keys(ks[1], cfg) if key is not None else (None,) * cfg.num_layers
        self.layers = nn.ModuleList(tf.Layer(k, cfg, device) for k in keys)
        self.final_norm = RMSNorm(d, cfg.norm_eps, dt, device)
        self.register_parameter(
            "lm_head", None if cfg.tie_embeddings else dense_param(ks[2], d, Vp, dt, device))

    @property
    def head(self) -> torch.Tensor:
        return self.embed.T if self.cfg.tie_embeddings else self.lm_head

    # ------------------------------------------------------ the reference's tree
    def param_tree(self, values: dict | None = None) -> dict:
        """The reference's parameter pytree of this model's parameters, or of
        ``values`` (parameter name → tensor, e.g. their gradients): ``embed``,
        ``final_norm``, ``lm_head`` unless tied, and ``stack`` = ``{"prefix":
        [a tree per prefix layer], "cycle": {str(j): the tree of cycle
        position j, each leaf stacked over the cycles (a copy)} or None}``."""
        values = dict(self.named_parameters()) if values is None else values
        tree = {"embed": values["embed"], "final_norm": values["final_norm" + _SCALE]}
        if self.lm_head is not None:
            tree["lm_head"] = values["lm_head"]

        def layer(i):
            out: dict = {}
            for name, _ in self.layers[i].named_parameters():
                *path, leaf = name.removesuffix(_SCALE).split(".")
                node = out
                for part in path:
                    node = node.setdefault(part, {})
                node[leaf] = values[f"layers.{i}.{name}"]
            return out

        cfg = self.cfg
        P, n, C = len(cfg.prefix_codes), len(cfg.cycle_codes), cfg.resolved_num_cycles
        cycle = None
        if C:
            cycle = {str(j): tree_map(lambda *ls: torch.stack(ls),
                                      *[layer(P + c * n + j) for c in range(C)])
                     for j in range(n)}
        tree["stack"] = {"prefix": [layer(i) for i in range(P)], "cycle": cycle}
        return tree

    def load_param_tree(self, tree: dict) -> "Model":
        """Copy a tree in the reference's layout (numpy arrays or tensors,
        cast to the parameters' dtype and device) into the parameters.
        Raises ``ValueError`` if a parameter of either side has no
        counterpart or another shape. Returns the model."""
        flat = _flatten({k: tree[k] for k in ("embed", "final_norm", "lm_head") if k in tree})
        for i, lt in enumerate(_layer_trees(tree, self.cfg)):
            flat.update(_flatten(lt, f"layers.{i}."))
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
    def forward_logits(self, batch: dict):
        """(logits (B, S, Vp), aux loss, loss mask (B, S)):
        :func:`repro_torch.models.transformer.forward_logits`."""
        return tf.forward_logits(self, batch)

    def loss_fn(self, batch: dict) -> torch.Tensor:
        """The next-token loss on ``{"tokens", "labels"}`` (B, S)."""
        logits, _, mask = self.forward_logits(batch)
        labels = batch["labels"]
        S_lab = labels.shape[1]
        # Logits cover the full sequence; labels cover the text positions:
        # take the tail, then shift by one token.
        logits = logits[:, -S_lab:]
        mask = mask[:, -S_lab:]
        return lm_loss(logits[:, :-1], labels[:, 1:], mask[:, 1:])

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
                split = {k: v.reshape((microbatches, B // microbatches) + tuple(v.shape[1:]))
                         for k, v in batch.items()}
                loss = torch.zeros((), dtype=torch.float32, device=self.embed.device)
                grads = [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                         for p in params]
                for i in range(microbatches):
                    l, g = value_and_grad({k: v[i] for k, v in split.items()})
                    loss = loss + l
                    grads = [a + b for a, b in zip(grads, g)]
                loss = loss / microbatches
                grads = [g / microbatches for g in grads]
            with torch.no_grad():
                new_params, opt_state = optimizer.update(
                    self.param_tree(dict(zip(names, grads))), opt_state, self.param_tree(),
                    step)
                self.load_param_tree(new_params)
            return opt_state, loss

        return train_step

    def example_batch(self, shape: InputShape, key=None) -> dict:
        """Concrete inputs of ``shape``'s kind on the model's device, drawn as
        the reference's are (``randint`` from ``key``, default
        ``PRNGKey(0)``; tokens and labels from the same key): ``train``
        ``{"tokens", "labels"}`` (B, S); ``prefill`` ``{"tokens"}``; the
        decode kinds ``{"token" (B, 1), "pos": S − 1}`` (an int, as
        :meth:`decode_step` takes it)."""
        B, S = shape.global_batch, shape.seq_len
        key = key if key is not None else prng.PRNGKey(0)
        V, dev = self.cfg.vocab_size, self.embed.device

        def toks(shape_):
            return prng.randint(key, shape_, 0, V, dev)

        if shape.kind == "train":
            return {"tokens": toks((B, S)), "labels": toks((B, S))}
        if shape.kind == "prefill":
            return {"tokens": toks((B, S))}
        return {"token": toks((B, 1)), "pos": S - 1}

    # ------------------------------------------------------------- serving
    def init_cache(self, batch: int, cache_len: int) -> list:
        return tf.init_cache(self.cfg, batch, cache_len, self.embed.device)

    def decode_step(self, cache: list, token: torch.Tensor, pos: int, *,
                    swa_kernel: bool = True):
        """token (B, 1) int on the model's device; ``pos`` a Python int.
        Returns (logits (B, 1, Vp), cache), the cache updated in place.
        ``swa_kernel=False`` runs full rings through the plain masked
        attention instead of K7. No gradient is taken, trainable or not."""
        with torch.no_grad():
            return tf.decode_step(self, cache, token, pos, swa_kernel=swa_kernel)

    def decode_cache_len(self, shape: InputShape) -> int:
        cfg = self.cfg
        if cfg.attention_window is not None:
            return min(shape.seq_len, cfg.attention_window)
        return shape.seq_len


def _layer_trees(tree: dict, cfg: ModelConfig) -> list:
    """The reference's per-layer parameter trees in layer order: prefix
    layers, then cycle c's position j (``[c]`` of the stacked cycle leaves)
    at ``len(prefix) + c·len(cycle_codes) + j``."""
    stack = tree["stack"]
    layers = list(stack["prefix"])
    if stack["cycle"] is not None:
        for c in range(cfg.resolved_num_cycles):
            for j in range(len(cfg.cycle_codes)):
                layers.append(tree_map(lambda a, c=c: a[c], stack["cycle"][str(j)]))
    return layers


def _flatten(tree: dict, prefix: str = "") -> dict:
    """A reference tree → ``{port parameter name: leaf}``."""
    out = {}
    for k, v in tree.items():
        name = f"{prefix}{k}"
        if isinstance(v, dict):
            out.update(_flatten(v, name + "."))
        else:
            out[name + _SCALE if k in ("norm", "norm2", "final_norm") else name] = v
    return out
