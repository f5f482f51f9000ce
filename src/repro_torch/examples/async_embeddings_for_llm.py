"""The paper's technique as a first-class framework feature: pretrain a
transformer's token-embedding table with asynchronous SGNS sub-models +
ALiR merge, then fine-tune the LM and compare against random init.

    PYTHONPATH=src python -m repro_torch.examples.async_embeddings_for_llm [--device cpu]

The counterpart of ``examples/async_embeddings_for_llm.py``, on the GPU
unless ``--device cpu``. Phase 1 trains the sub-models with
``run_pipeline`` (the ``fused`` engine); phase 2 publishes the merge as a
versioned artifact and fetches the embedding table through the batched
:class:`~repro_torch.serve.EmbeddingServer` — the same read path a
production consumer would use; phase 3 fine-tunes smollm-360m (reduced)
from a random and from the pretrained table with the port's train step.
ALiR's OOV reconstruction is what makes this integration work: any vocab
entry present in ≥1 sub-model gets a consensus vector; the rest keep their
random init.
"""

import argparse
import asyncio
import copy
import tempfile

import numpy as np
import torch

from repro_torch import prng
from repro_torch.configs import get_config
from repro_torch.core.driver import run_pipeline
from repro_torch.core.sgns import SGNSConfig
from repro_torch.data.corpus import SemanticCorpusModel
from repro_torch.device import resolve_device
from repro_torch.models import Model
from repro_torch.optim import get_optimizer
from repro_torch.serve import EmbeddingServer, ServeConfig, publish_incremental
from repro_torch.serve.publish import submodel_arrivals

#: Epochs of the phase-1 pretraining (one ``fused`` step a training step).
PRETRAIN_EPOCHS = 8


def make_lm_batches(corpus, vocab_size, batch, seq, steps, seed=0):
    """``(batch, seq)`` int32 numpy windows at random starts, the
    reference's bitwise."""
    toks = corpus.tokens % vocab_size
    rng = np.random.default_rng(seed)
    for _ in range(steps):
        starts = rng.integers(0, len(toks) - seq - 1, size=batch)
        yield np.stack([toks[s:s + seq] for s in starts]).astype(np.int32)


def train_lm(model, corpus, steps=60, batch=8, seq=48, lr=3e-3):
    """AdamW fine-tuning of ``model`` in place; returns the step losses."""
    opt = get_optimizer("adamw", lr=lr)
    with torch.no_grad():
        state = opt.init(model.param_tree())
    step_fn = model.make_train_step(opt)
    dev = model.embed.device
    losses = []
    for i, toks in enumerate(make_lm_batches(corpus, model.cfg.vocab_size, batch,
                                             seq, steps)):
        toks = torch.from_numpy(toks).to(dev)
        state, loss = step_fn(state, {"tokens": toks, "labels": toks}, i)
        losses.append(float(loss))
    return losses


async def fetch_table(artifact_dir, raw_ids, device):
    """Pull pretrained vectors through the serving tier: batched,
    coalesced lookups against the latest published artifact version."""
    server = EmbeddingServer(artifact_dir, ServeConfig(coalesce_ms=1.0), device=device)
    out = await server.embed_ids(np.asarray(raw_ids))
    s = server.stats()
    print(f"fetched {len(raw_ids)} vectors from artifact "
          f"v{out['version']} in {s['dispatches']} coalesced dispatches "
          f"(mean batch {s['mean_batch']:.0f})")
    return out["vectors"], out["found"]


def main(argv=None):
    """Run the three phases; returns the pretraining's ``timings`` and both
    fine-tunings' losses."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the GPU; 'cpu' to run here)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    cfg = get_config("smollm-360m").reduced()
    d = cfg.d_model

    gen = SemanticCorpusModel.create(vocab_size=cfg.vocab_size, seed=0)
    corpus = gen.generate(num_sentences=15_000, seed=1)

    # Phase 1: the paper — async sub-models + ALiR merge, at the LM's
    # dim; publish the incremental merge as a versioned artifact.
    res = run_pipeline(
        corpus, cfg.vocab_size, strategy="shuffle", num_workers=4,
        cfg=SGNSConfig(vocab_size=0, dim=d, window=5, negatives=5),
        epochs=PRETRAIN_EPOCHS, batch_size=512, window=5, max_vocab=None,
        merge_methods=(), device=device)
    print(f"async embedding pretrain: {res.timings['train_s']:.1f}s; "
          f"publishing incremental merge…")

    # Phase 2: initialize the LM embedding table via the serving tier —
    # the LM is just another client of the published artifact.
    with tempfile.TemporaryDirectory() as td:
        publish_incremental(submodel_arrivals(res.stacked), td,
                            word_ids=res.union_vocab.word_ids, device=device)
        emb, found = asyncio.run(fetch_table(td, np.arange(cfg.vocab_size), device))
    print(f"{int(found.sum())}/{cfg.vocab_size} vocab covered by the "
          f"merged model")

    model_rand = Model(cfg, prng.PRNGKey(0), device=device)
    model_pre = copy.deepcopy(model_rand)
    table = model_pre.embed.detach().cpu().numpy().astype(np.float32)
    scale = np.std(table) / (np.std(emb[found]) + 1e-9)
    table = np.where(found[:, None], emb * scale, table)
    with torch.no_grad():
        model_pre.embed.copy_(torch.from_numpy(table))

    # Phase 3: fine-tune both and compare.
    steps = 100
    l_rand = train_lm(model_rand, corpus, steps=steps)
    l_pre = train_lm(model_pre, corpus, steps=steps)
    k = 10
    print(f"LM loss, first {k} steps — random init: "
          f"{np.mean(l_rand[:k]):.3f} | ALiR-pretrained: "
          f"{np.mean(l_pre[:k]):.3f}")
    print(f"LM loss, last {k} of {steps} — random init: "
          f"{np.mean(l_rand[-k:]):.4f} | ALiR-pretrained: "
          f"{np.mean(l_pre[-k:]):.4f}")
    print("(pretrained-embedding init should lead on both)")
    return {"timings": res.timings, "loss_random": l_rand, "loss_pretrained": l_pre}


if __name__ == "__main__":
    main()
