"""Data substrate: corpus synthesis, vocabulary, skip-gram pairs, streams
(numpy, bitwise equal to ``repro.data``; noise tables as torch tensors).
The package exports the names ``repro.data`` exports."""

from repro_torch.data.corpus import Corpus, SemanticCorpusModel
from repro_torch.data.pairs import (
    AliasSampler,
    NegativeSampler,
    build_noise_table,
    extract_pairs,
    negative_sampler_fn,
    stack_noise_tables,
    subsample_mask,
)
from repro_torch.data.pipeline import (
    HostShardPlan,
    PairChunkStream,
    WorkerStream,
    make_worker_streams,
    prefetch_chunks,
    stacked_pair_batches,
)
from repro_torch.data.vocab import Vocab, build_vocab

__all__ = [
    "SemanticCorpusModel",
    "Corpus",
    "Vocab",
    "build_vocab",
    "extract_pairs",
    "AliasSampler",
    "NegativeSampler",
    "negative_sampler_fn",
    "build_noise_table",
    "stack_noise_tables",
    "subsample_mask",
    "HostShardPlan",
    "PairChunkStream",
    "WorkerStream",
    "make_worker_streams",
    "prefetch_chunks",
    "stacked_pair_batches",
]
