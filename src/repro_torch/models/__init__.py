"""The LLM decode path of the seed scaffolding, in torch: layers, GQA
attention (full rings through K7), the layer stack and the model facade."""

from repro_torch.models.model import Model

__all__ = ["Model"]
