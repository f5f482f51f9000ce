"""Data substrate: corpus synthesis, vocabulary, skip-gram pairs, streams
(numpy, bitwise equal to ``repro.data``; noise tables as torch tensors)."""
