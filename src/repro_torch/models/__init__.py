"""The LLM path of the seed scaffolding, in torch, for every arch of the
registry: layers (RoPE, M-RoPE), GQA attention (full rings of decode
through K7), cross-attention and MLA, the MoE FFN, the Mamba, mLSTM and
sLSTM mixers, the layer stack and encoder, the full-sequence forward, the
LM loss, the training step and the model facade."""

from repro_torch.models.model import Model

__all__ = ["Model"]
