"""PyTorch/CUDA port of the asynchronous word-embedding system, for one
NVIDIA H100: divide → train n SGNS sub-models with zero collectives →
merge with ALiR → evaluate.

It mirrors ``repro``'s layout and public names (``repro_torch.core.driver
.train_submodels`` is the counterpart of ``repro.core.driver
.train_submodels``) and never imports ``jax`` or ``repro``. The fused SGNS
step and its negative draw are CUDA kernels for Hopper (``csrc/``), built
with ``nvcc`` at first use. Entry points run on the GPU unless the caller
passes ``device="cpu"``.

The seed scaffolding's LLM decode path is ported too, for the dense GQA
family: ``configs`` (copies of the reference's), ``models`` and
``launch.decode_llm``, whose sliding-window layers run K7
(``swa_decode``) once their ring is full.
"""

__version__ = "0.1.0"
