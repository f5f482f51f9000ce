"""The LLM path of the seed scaffolding, in torch: layers, GQA attention
(full rings of decode through K7), the layer stack, the full-sequence
forward, the LM loss, the training step and the model facade."""

from repro_torch.models.model import Model

__all__ = ["Model"]
