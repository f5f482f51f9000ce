"""The paper's own model: SGNS word2vec, Wikipedia-scale settings.

dim 500, window 10, 300k vocab cap (paper §4.2); negatives default 5.
This is not a transformer config — it parameterizes repro_torch.core
(a copy of ``repro.configs.sgns_wiki``)."""

from repro_torch.core.sgns import SGNSConfig

CONFIG = SGNSConfig(
    vocab_size=300_000,
    dim=500,
    window=10,
    negatives=5,
    lr=0.025,
)

# Paper experiment grid (Tables 2–4): sampling rates r% → n = 100/r workers.
SAMPLING_RATES = (0.01, 0.05, 0.0667, 0.10, 0.20, 0.25, 0.33, 0.50)
