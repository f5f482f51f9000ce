"""The model facade for serving — the counterpart of ``repro.models.Model``'s
``init``, ``init_cache``, ``make_decode_step`` and ``decode_cache_len``.

``Model(cfg, key)`` holds the parameters that the reference's
``Model(cfg).init(key)`` returns, drawn from the same keys in the same
``(in, out)`` layout, as an ``nn.Module``; ``Model(cfg)`` (no key) leaves
them uninitialised for :func:`repro_torch.convert.from_jax_model_params`.
:meth:`Model.decode_step` is the function ``make_decode_step()`` returns,
with the parameters bound. The loss, the training step and the example
batches wait for a later slice (``ROADMAP.md`` queue 1 item 12).
"""

from __future__ import annotations

import torch
from torch import nn

from repro_torch import prng
from repro_torch.configs.base import ModelConfig
from repro_torch.configs.shapes import InputShape
from repro_torch.device import resolve_device
from repro_torch.models import transformer as tf
from repro_torch.models.layers import RMSNorm, dense_param, embed_init, frozen


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

    def init_cache(self, batch: int, cache_len: int) -> list:
        return tf.init_cache(self.cfg, batch, cache_len, self.embed.device)

    def decode_step(self, cache: list, token: torch.Tensor, pos: int, *,
                    swa_kernel: bool = True):
        """token (B, 1) int on the model's device; ``pos`` a Python int.
        Returns (logits (B, 1, Vp), cache), the cache updated in place.
        ``swa_kernel=False`` runs full rings through the plain masked
        attention instead of K7."""
        return tf.decode_step(self, cache, token, pos, swa_kernel=swa_kernel)

    def decode_cache_len(self, shape: InputShape) -> int:
        cfg = self.cfg
        if cfg.attention_window is not None:
            return min(shape.seq_len, cfg.attention_window)
        return shape.seq_len
