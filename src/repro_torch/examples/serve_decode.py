"""The full train → publish → serve loop, end to end.

    PYTHONPATH=src python -m repro_torch.examples.serve_decode [--device cpu]

The counterpart of ``examples/serve_decode.py``, on the GPU unless
``--device cpu``. Trains async SGNS sub-models (``fused``) with
per-worker vocabularies (RANDOM sampling — sub-models genuinely miss
words), folds them through the **incremental** ALiR merger publishing a
versioned artifact per fold, then stands up the batched asyncio
:class:`EmbeddingServer` over the artifact directory (its table on the
device) and decodes nearest neighbors from served vectors:

* a hot-reload: queries start at artifact v1 (one folded sub-model) and
  pick up the final version as later folds publish;
* coalesced concurrent lookups (one batched gather per window);
* a word absent from a sub-model served in that sub-model's own space —
  reconstructed on the fly (``Y @ W_i.T``), the paper's robustness
  claim as a serving feature.
"""

import argparse
import asyncio
import tempfile

import numpy as np

from repro_torch.core.driver import run_pipeline
from repro_torch.core.merge import IncrementalAlirMerger
from repro_torch.core.sgns import SGNSConfig
from repro_torch.data.corpus import SemanticCorpusModel
from repro_torch.device import resolve_device
from repro_torch.serve import EmbeddingServer, ServeConfig, publish_incremental
from repro_torch.serve.publish import submodel_arrivals

VOCAB, WORKERS, DIM = 900, 4, 32


def train(device, workers=WORKERS):
    gen = SemanticCorpusModel.create(vocab_size=VOCAB, seed=0)
    corpus = gen.generate(num_sentences=8_000, seed=1)
    # RANDOM sampling: each worker builds its own vocabulary, so the
    # presence mask has real holes — the OOV serving path is exercised.
    return run_pipeline(
        corpus, VOCAB, strategy="random", num_workers=workers,
        cfg=SGNSConfig(vocab_size=0, dim=DIM, window=5, negatives=5),
        epochs=2, batch_size=512, window=5, max_vocab=None,
        base_min_count=8, merge_methods=(), device=device)


async def decode(server: EmbeddingServer, res, query_raw_ids):
    """Nearest-neighbor decode of served vectors against the served
    table itself (all through the same batched query path)."""
    union = res.union_vocab
    all_rows = np.arange(union.size)
    table = (await server.embed_rows(all_rows))["vectors"]
    norm = table / (np.linalg.norm(table, axis=1, keepdims=True) + 1e-9)
    out = (await server.embed_ids(np.asarray(query_raw_ids)))
    for rid, vec, ok in zip(query_raw_ids, out["vectors"], out["found"]):
        if not ok:
            print(f"  raw id {rid}: not covered yet")
            continue
        v = vec / (np.linalg.norm(vec) + 1e-9)
        sims = norm @ v
        sims[union.lookup[rid]] = -np.inf      # not itself
        nn = np.argsort(-sims)[:3]
        print(f"  raw id {rid:>4d} → neighbors "
              f"{[int(union.word_ids[j]) for j in nn]} "
              f"(cos {[round(float(sims[j]), 2) for j in nn]})")
    return out


async def main_async(res, artifact_dir, device):
    mask = res.stacked.mask.cpu().numpy()
    word_ids = res.union_vocab.word_ids

    # Publish fold 1 only, stand the server up on it (no wait-for-all)…
    arrivals = list(submodel_arrivals(res.stacked))
    merger = IncrementalAlirMerger(device=device)
    publish_incremental(arrivals[:1], artifact_dir, word_ids=word_ids,
                        merger=merger, final_cold_fold=False)
    server = EmbeddingServer(artifact_dir,
                             ServeConfig(coalesce_ms=1.0, cache_rows=2048),
                             device=device)
    v0 = server.store.version
    print(f"serving starts at artifact v{v0} "
          f"({int(server.store.table.valid_host.sum())} rows valid)")

    # …then the remaining workers "finish", fold into the SAME merger
    # (warm folds + a final cold canonical solve) and the server
    # hot-swaps to the latest published version.
    publish_incremental(arrivals[1:], artifact_dir, word_ids=word_ids, merger=merger)
    server.refresh()
    print(f"hot-swapped to artifact v{server.store.version} "
          f"({int(server.store.table.valid_host.sum())} rows valid)")

    # Batched concurrent decode through the coalescer.
    hot = word_ids[:8].tolist()
    await decode(server, res, hot)

    # The OOV serving feature: a word some sub-model never saw, queried
    # in THAT sub-model's space, reconstructed on the fly.
    table = server.store.table
    w, m = np.nonzero(~table.mask.cpu().numpy())
    if len(w):
        axis, row = int(w[0]), int(m[0])
        worker = int(table.worker_ids[axis])
        rec = (await server.embed_rows([row], submodel=worker))["vectors"][0]
        print(f"row {row} is absent from worker {worker}'s sub-model → "
              f"reconstructed ‖v‖={np.linalg.norm(rec):.3f} "
              f"(= Y[{row}] @ W_{worker}ᵀ, served)")

    s = server.stats()
    print(f"serving stats: {s['requests']} lookups in {s['dispatches']} "
          f"coalesced dispatches (mean batch {s['mean_batch']:.1f}), "
          f"p50 {s['p50_ms']:.2f} ms, p99 {s['p99_ms']:.2f} ms, "
          f"cache hit rate {s['cache_hit_rate']:.2f}")
    if s["mean_batch"] <= 1.0:
        raise RuntimeError("coalescing should batch concurrent lookups")
    print(f"sub-model coverage: "
          f"{mask.sum(axis=1).tolist()} of {mask.shape[1]} union rows each")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the GPU; 'cpu' to run here)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    res = train(device)
    print(f"trained {WORKERS} async sub-models in "
          f"{res.timings['train_s']:.1f}s; folding + publishing…")
    with tempfile.TemporaryDirectory() as td:
        asyncio.run(main_async(res, td, device))


if __name__ == "__main__":
    main()
