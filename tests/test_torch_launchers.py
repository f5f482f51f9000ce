"""The port's launchers against the JAX package's, on the CPU.

* ``train_sgns`` on both packages with the same arguments (``--engine
  sparse --strategy random --workers 2 --epochs 1 --dim 16 --vocab 400
  --sentences 3000 --merge concat --publish DIR --save PATH``, the port
  with ``--device cpu``): every published version's ``word_ids``,
  ``worker_ids``, ``mask`` and ``valid`` bitwise equal, ``emb`` within
  1e-4 after Procrustes (``test_torch_slice.py``'s merge tolerance), the
  saved merged tables within the same bound, the manifests' fields equal;
* each package's serve CLI on the other package's artifact;
* ``train_sgns --elastic-state`` of both packages on the same arguments
  (the same published ids bitwise, tables by the rule above, the worker
  states within 1e-5); a second run of the port's command trains nothing
  and saves the same table bitwise; a state directory the reference's CLI
  left mid-run (its last checkpoint of one worker lost to a kill between
  the table and the manifest write) is finished by the port's CLI within
  1e-5 of the reference's own finish;
* the parsers: the port's flags are the reference's plus ``--device``,
  with the port's defaults for ``--engine`` (``fused``) and
  ``--vmem-budget-mb`` (the H100's opt-in 227 KiB of shared memory a CTA,
  in MiB); a budget below the engine's footprint raises, as the
  reference's does, and ``--processes 2`` without a rendezvous raises;
* the engine names of either package, mapped to the port's;
* the LM training launcher (``launch/train.py``): ``tests/test_launchers.py``'s
  two tests on the port (the loss falls; the checkpoint's ``step``,
  ``params`` and ``opt``; a resume), ``synthetic_lm_batches`` bitwise, 25
  steps of qwen1.5-0.5b (reduced) from the reference's init against the
  reference's losses (rtol 1e-5: 25 AdamW steps on the same batches, the
  forward's and gradients' sums in another order), and each package
  resuming the other's checkpoint: both resumes from one checkpoint give
  the same losses (rtol 1e-5) and write the same ``.npz`` keys;
* the LLM CLIs on an MoE (qwen3-moe-30b-a3b), an SSM (xlstm-1.3b) and the
  encoder-decoder (seamless-m4t-large-v2), reduced: ``decode_llm`` prints
  the reference CLI's first sequence; ``train`` (3 steps) its final and
  first losses within their printed digit (and xlstm's AdamW rtol);
* ``examples/async_embeddings_for_llm.py``: ``make_lm_batches`` bitwise and
  3 steps of ``train_lm`` from the reference's parameters against the
  reference's losses (rtol 1e-5). The whole example is not run here (the
  reference's takes about 3 minutes on the CPU).
"""

import argparse
import contextlib
import importlib.util
import io
import json
import os
import shutil
from pathlib import Path

import numpy as np
import pytest

from repro.checkpoint import load_checkpoint as jload_checkpoint
from repro.checkpoint import load_manifest as jload_manifest
from repro.checkpoint import load_table as jload_table
from repro.launch import serve as jserve
from repro.launch import train as jlm
from repro.launch import train_sgns as jtrain
from repro_torch.analysis.vmem import DEFAULT_VMEM_BUDGET_BYTES, VmemBudgetError
from repro_torch.checkpoint import load_checkpoint, load_table
from repro_torch.checkpoint.io import load_worker_state
from repro_torch.core.async_trainer import AsyncShardTrainer
from repro_torch.core.engine import REFERENCE_ENGINE, get_engine, port_engine_spec
from repro_torch.launch import serve as tserve
from repro_torch.launch import train as tlm
from repro_torch.launch import train_sgns as ttrain

MERGE_ATOL = 1e-4
ARGS = ["--engine", "sparse", "--strategy", "random", "--workers", "2", "--epochs", "1",
        "--dim", "16", "--vocab", "400", "--sentences", "3000", "--merge", "concat"]


def _run(main, argv) -> str:
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        main(argv)
    return buf.getvalue()


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """Both CLIs trained and published once, from the same arguments."""
    root = tmp_path_factory.mktemp("cli")
    out = {}
    for pkg, main, extra in (("port", ttrain.main, ["--device", "cpu"]),
                             ("repro", jtrain.main, [])):
        art, ckpt = str(root / pkg / "art"), str(root / pkg / "merged.npz")
        text = _run(main, ARGS + ["--publish", art, "--save", ckpt] + extra)
        out[pkg] = {"art": art, "ckpt": ckpt, "out": text}
    return out


@pytest.fixture(scope="module")
def elastic_trained(tmp_path_factory):
    """Both CLIs trained with --elastic-state, published and saved once."""
    root = tmp_path_factory.mktemp("elastic_cli")
    out = {}
    for pkg, main, extra in (("port", ttrain.main, ["--device", "cpu"]),
                             ("repro", jtrain.main, [])):
        d = {k: str(root / pkg / k) for k in ("state", "art", "merged.npz")}
        d["out"] = _run(main, ARGS + ["--elastic-state", d["state"], "--publish", d["art"],
                                      "--save", d["merged.npz"]] + extra)
        out[pkg] = d
    return out


def _worker_epochs(monkeypatch) -> list:
    """Count the port trainer's per-worker chunks (the elastic path's only
    training call)."""
    calls = []
    real = AsyncShardTrainer.worker_epoch
    monkeypatch.setattr(AsyncShardTrainer, "worker_epoch",
                        lambda self, *a, **k: calls.append(1) or real(self, *a, **k))
    return calls


def _procrustes_err(A, B):
    u, _, vt = np.linalg.svd(A.T @ B)
    return float(np.abs(A @ (u @ vt) - B).max())


def test_train_sgns_publishes_what_the_reference_publishes(trained):
    port, ref = trained["port"], trained["repro"]
    for text in (port["out"], ref["out"]):
        assert "published 2 incremental table version(s)" in text
        assert "sim=" in text and "saved merged embedding" in text
    assert "engine=sparse:cdf" in port["out"] and "vmem: sparse:cdf" in port["out"]
    assert "vmem: sparse:cdf" in ref["out"]
    m_t, m_j = jload_manifest(port["art"]), jload_manifest(ref["art"])
    assert m_t["latest"] == m_j["latest"] == 2
    for e_t, e_j in zip(m_t["versions"], m_j["versions"]):
        assert {k: v for k, v in e_t.items() if k != "created_unix"} == \
               {k: v for k, v in e_j.items() if k != "created_unix"}
    for v in (1, 2):
        t, j = load_table(port["art"], v), jload_table(ref["art"], v)
        for k in ("word_ids", "worker_ids", "mask", "valid"):
            got, want = getattr(t, k), getattr(j, k)
            assert got.dtype == want.dtype, k
            np.testing.assert_array_equal(got, want, err_msg=k)
        assert _procrustes_err(t.emb, j.emb) < MERGE_ATOL, v
        np.testing.assert_allclose(t.models, j.models, rtol=0, atol=1e-5)
    saved_t, meta_t = load_checkpoint(port["ckpt"])
    saved_j, meta_j = jload_checkpoint(ref["ckpt"])
    assert meta_t == meta_j == {"step": None, "method": "concat", "strategy": "random"}
    for k in ("word_ids", "valid"):
        np.testing.assert_array_equal(saved_t[k], saved_j[k])
    np.testing.assert_allclose(saved_t["embedding"], saved_j["embedding"], rtol=0,
                               atol=MERGE_ATOL)


def test_train_sgns_elastic_publishes_what_the_reference_publishes(elastic_trained):
    port, ref = elastic_trained["port"], elastic_trained["repro"]
    for text in (port["out"], ref["out"]):
        assert "published 2 incremental table version(s)" in text
    assert "engine=sparse:cdf" in port["out"]
    for v in (1, 2):
        t, j = load_table(port["art"], v), jload_table(ref["art"], v)
        for k in ("word_ids", "worker_ids", "mask", "valid"):
            np.testing.assert_array_equal(getattr(t, k), getattr(j, k), err_msg=k)
        assert _procrustes_err(t.emb, j.emb) < MERGE_ATOL, v
        np.testing.assert_allclose(t.models, j.models, rtol=0, atol=1e-5)
    saved_t, meta_t = load_checkpoint(port["merged.npz"])
    saved_j, meta_j = jload_checkpoint(ref["merged.npz"])
    assert meta_t == meta_j
    np.testing.assert_array_equal(saved_t["word_ids"], saved_j["word_ids"])
    np.testing.assert_allclose(saved_t["embedding"], saved_j["embedding"], rtol=0,
                               atol=MERGE_ATOL)
    for w in range(2):
        (pt, ct, vt), (pj, cj, vj) = (load_worker_state(port["state"], w),
                                      load_worker_state(ref["state"], w))
        assert ct == cj and vt == vj
        for k in ("W", "C"):
            np.testing.assert_allclose(pt[k], pj[k], rtol=0, atol=1e-5)


def test_train_sgns_elastic_rerun_trains_nothing(elastic_trained, tmp_path, monkeypatch):
    port = elastic_trained["port"]
    manifests = {w: json.load(open(os.path.join(port["state"], f"worker_{w:04d}",
                                                "MANIFEST.json"))) for w in range(2)}
    calls = _worker_epochs(monkeypatch)
    again = str(tmp_path / "merged.npz")
    text = _run(ttrain.main, ARGS + ["--elastic-state", port["state"], "--save", again,
                                     "--device", "cpu"])
    assert calls == [] and "losses=['nan']" in text
    for w in range(2):
        assert json.load(open(os.path.join(port["state"], f"worker_{w:04d}",
                                           "MANIFEST.json"))) == manifests[w]
    first, _ = load_checkpoint(port["merged.npz"])
    second, _ = load_checkpoint(again)
    for k in ("embedding", "valid", "word_ids"):
        np.testing.assert_array_equal(first[k], second[k])


def test_port_cli_finishes_a_state_dir_the_reference_cli_left(tmp_path, monkeypatch):
    """The reference's CLI trains 2 epochs; worker 1's final checkpoint is
    then lost as a kill between the table and the manifest rename loses
    it (the table file stays, an orphan). The port's CLI resumes the
    directory, trains only that worker's last epoch and lands within 1e-5
    of the reference's final tables; worker 0 is not touched."""
    state = str(tmp_path / "state")
    argv = ARGS + ["--epochs", "2", "--elastic-state", state]
    _run(jtrain.main, argv)
    want = {w: load_worker_state(state, w) for w in range(2)}
    mpath = os.path.join(state, "worker_0001", "MANIFEST.json")
    manifest = json.load(open(mpath))
    manifest["versions"].pop()
    manifest["latest"] = manifest["versions"][-1]["version"]
    json.dump(manifest, open(mpath, "w"))
    assert load_worker_state(state, 1)[1]["epoch"] == 1
    calls = _worker_epochs(monkeypatch)
    _run(ttrain.main, argv + ["--device", "cpu"])
    assert len(calls) == 1                         # one chunk: worker 1's epoch 1
    got = {w: load_worker_state(state, w) for w in range(2)}
    assert got[0][2] == want[0][2] and got[1][2] == want[1][2] + 1
    for k in ("W", "C"):
        np.testing.assert_array_equal(got[0][0][k], want[0][0][k])
        np.testing.assert_allclose(got[1][0][k], want[1][0][k], rtol=0, atol=1e-5)
    assert got[1][1] == want[1][1]


@pytest.mark.parametrize("serve_pkg,art_pkg", [("port", "repro"), ("repro", "port")])
def test_serve_cli_reads_the_other_packages_artifact(trained, serve_pkg, art_pkg):
    art = trained[art_pkg]["art"]
    main, extra = ((tserve.main, ["--device", "cpu"]) if serve_pkg == "port"
                   else (jserve.main, []))
    out = _run(main, ["--artifact", art, "--query", "1,2,3,999999"] + extra)
    assert "artifact v2" in out and "space=merged" in out
    assert "[OOV]" in out and "stats:" in out
    out = _run(main, ["--artifact", art, "--query", "1,2", "--submodel", "0",
                      "--version", "1"] + extra)
    assert "artifact v1" in out and "space=submodel 0" in out


def test_serve_cli_prints_what_the_reference_prints(trained):
    art = trained["repro"]["art"]
    q = ["--artifact", art, "--query", "1,2,3,999999", "--submodel", "1"]
    ours = _run(tserve.main, q + ["--device", "cpu"]).splitlines()
    ref = _run(jserve.main, q).splitlines()
    assert ours[:-1] == ref[:-1]                  # all but the timings line
    assert ours[-1].startswith("stats:") and ref[-1].startswith("stats:")


class _Captured(Exception):
    pass


def _reference_parser(main, monkeypatch) -> argparse.ArgumentParser:
    """The parser a reference ``main`` builds, caught at ``parse_args``."""
    def capture(self, *a, **k):
        raise _Captured(self)

    with monkeypatch.context() as m:
        m.setattr(argparse.ArgumentParser, "parse_args", capture)
        with pytest.raises(_Captured) as exc:
            main([])
    return exc.value.args[0]


def _flags(ap: argparse.ArgumentParser) -> dict:
    return {tuple(a.option_strings): (a.dest, a.default, a.type, a.nargs, a.choices,
                                      a.required, type(a).__name__)
            for a in ap._actions if a.option_strings and a.dest != "help"}


@pytest.mark.parametrize("name", ("train_sgns", "serve", "train"))
def test_parsers_are_the_reference_ones_plus_device(name, monkeypatch):
    port_mod, ref_mod = {"train_sgns": (ttrain, jtrain), "serve": (tserve, jserve),
                         "train": (tlm, jlm)}[name]
    ours = _flags(port_mod.build_parser())
    ref = _flags(_reference_parser(ref_mod.main, monkeypatch))
    assert ours.pop(("--device",))[:2] == ("device", None)
    changed = {k for k in ref if ours[k] != ref[k]}
    assert set(ours) == set(ref)
    if name == "train_sgns":
        assert changed == {("--engine",), ("--vmem-budget-mb",)}
        assert ours[("--engine",)][1] == "fused" and ref[("--engine",)][1] == "sparse"
        assert ours[("--vmem-budget-mb",)][1] == DEFAULT_VMEM_BUDGET_BYTES / 2 ** 20
        assert ref[("--vmem-budget-mb",)][1] == 16.0
        for k in changed:
            assert ours[k][0] == ref[k][0] and ours[k][2:] == ref[k][2:]
    else:
        assert not changed


@pytest.mark.parametrize("flags,exc,match", [
    (["--engine", "fused", "--vmem-budget-mb", "0.05"], VmemBudgetError, "budget exceeded"),
    (["--processes", "2", "--process-index", "0"], ValueError, "MASTER_ADDR"),
])
def test_flags_waiting_on_later_items_raise(flags, exc, match, monkeypatch):
    """The flags the port once refused now work; what still raises is what
    the reference refuses too (a budget below the engine's shared memory a
    CTA: the reference's budget check) or a run that cannot form its
    process group (no ``MASTER_ADDR`` and no ``REPRO_TORCH_INIT_METHOD``)."""
    monkeypatch.delenv("MASTER_ADDR", raising=False)
    monkeypatch.delenv("REPRO_TORCH_INIT_METHOD", raising=False)
    with pytest.raises(exc, match=match):
        ttrain.main(ARGS + ["--device", "cpu"] + flags)
    from repro.analysis.vmem import VmemBudgetError as JVmemBudgetError

    if exc is VmemBudgetError:
        with pytest.raises(JVmemBudgetError):
            jtrain.main(ARGS[:1] + ["pallas_fused"] + ARGS[2:] + ["--vmem-budget-mb", "0.05"])


def test_engine_names_of_either_package():
    for ours, ref in REFERENCE_ENGINE.items():
        assert port_engine_spec(ref) == ours == port_engine_spec(ours)
    assert port_engine_spec("pallas:cdf") == "rowgrad:cdf"
    assert port_engine_spec("pallas_fused_hbm:alias") == "fused_hbm:alias"
    assert get_engine(port_engine_spec("sparse:alias")).describe() == "sparse:alias"
    with pytest.raises(ValueError, match="unknown update engine"):
        get_engine(port_engine_spec("pallas_nope"))


# ---------------------------------------------------------------------------
# The LM training launcher and the example that joins the LM to the paper
# ---------------------------------------------------------------------------
@pytest.fixture
def one_torch_thread():
    """A reduced LM's ops are too small to split across threads; beside other
    test processes on the machine, torch's thread pool only contends."""
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.usefixtures("one_torch_thread")
def test_lm_train_launcher_reduces_loss(tmp_path):
    _, losses, _ = tlm.train("qwen1.5-0.5b", reduced=True, steps=25, batch=4, seq=48,
                             lr=3e-3, ckpt_dir=str(tmp_path), ckpt_every=20, device="cpu")
    assert losses[-1] < losses[0]
    from repro_torch.checkpoint import latest_step_path
    path = latest_step_path(str(tmp_path))
    assert path is not None
    tree, meta = load_checkpoint(path)
    assert meta["step"] == 25
    assert "params" in tree and "opt" in tree
    assert os.path.exists(tmp_path / "step_20.npz")


@pytest.mark.usefixtures("one_torch_thread")
def test_lm_train_launcher_resume(tmp_path):
    tlm.train("smollm-360m", reduced=True, steps=10, batch=2, seq=32, lr=1e-3,
              ckpt_dir=str(tmp_path), ckpt_every=100, device="cpu")
    _, losses, _ = tlm.train("smollm-360m", reduced=True, steps=5, batch=2, seq=32, lr=1e-3,
                             ckpt_dir=str(tmp_path), ckpt_every=100, resume=True,
                             device="cpu")
    assert len(losses) > 0 and np.isfinite(losses).all()
    assert load_checkpoint(str(tmp_path / "step_15.npz"))[1]["step"] == 15


@pytest.mark.parametrize("vocab,batch,seq,steps", [(512, 4, 48, 25), (49152, 2, 1024, 3)])
def test_synthetic_lm_batches_are_the_reference_batches(vocab, batch, seq, steps):
    ours = list(tlm.synthetic_lm_batches(vocab, batch, seq, steps))
    ref = list(jlm.synthetic_lm_batches(vocab, batch, seq, steps))
    assert len(ours) == len(ref) == steps
    for a, b in zip(ours, ref):
        assert a.dtype == np.int32 and a.shape == (batch, seq)
        np.testing.assert_array_equal(a, np.asarray(b))


def _reference_init_checkpoint(arch, ckpt_dir):
    """The reference's ``PRNGKey(0)`` init and fresh optimizer state as a
    step-0 checkpoint: a ``resume`` of either launcher starts from it."""
    import jax
    from repro.checkpoint import save_checkpoint as jsave
    from repro.configs import get_config
    from repro.models import Model as JaxModel
    from repro.optim import get_optimizer as jget

    cfg = get_config(arch).reduced()
    params = JaxModel(cfg).init(jax.random.PRNGKey(0))
    opt = jget(cfg.train_optimizer)
    jsave(f"{ckpt_dir}/step_0.npz", {"params": params, "opt": opt.init(params)}, step=0)


@pytest.mark.usefixtures("one_torch_thread")
def test_lm_train_launcher_matches_the_reference_losses(tmp_path):
    kw = dict(reduced=True, steps=25, batch=4, seq=48, lr=3e-3, ckpt_every=100, resume=True)
    for pkg in ("repro", "port"):
        _reference_init_checkpoint("qwen1.5-0.5b", tmp_path / pkg)
    with contextlib.redirect_stdout(io.StringIO()):
        _, ref = jlm.train("qwen1.5-0.5b", ckpt_dir=str(tmp_path / "repro"), **kw)
        _, ours, _ = tlm.train("qwen1.5-0.5b", ckpt_dir=str(tmp_path / "port"), device="cpu",
                               **kw)
    np.testing.assert_allclose(ours, ref, rtol=1e-5)
    assert ours[-1] < ours[0]


@pytest.mark.usefixtures("one_torch_thread")
@pytest.mark.parametrize("first", ["repro", "port"])
def test_lm_checkpoints_resume_across_packages(tmp_path, first):
    """One package trains 10 steps and saves; each package resumes that
    checkpoint for 5 steps in a copy of the directory."""
    kw = dict(reduced=True, batch=2, seq=32, lr=1e-3, ckpt_every=100)
    run = {"repro": lambda d, **k: jlm.train("smollm-360m", ckpt_dir=str(d), **kw, **k)[1],
           "port": lambda d, **k: tlm.train("smollm-360m", ckpt_dir=str(d), device="cpu",
                                             **kw, **k)[1]}
    with contextlib.redirect_stdout(io.StringIO()):
        run[first](tmp_path / "first", steps=10)
        losses = {}
        for pkg in ("repro", "port"):
            shutil.copytree(tmp_path / "first", tmp_path / pkg)
            losses[pkg] = run[pkg](tmp_path / pkg, steps=5, resume=True)
    np.testing.assert_allclose(losses["port"], losses["repro"], rtol=1e-5)
    keys = {}
    for pkg in ("repro", "port"):
        with np.load(tmp_path / pkg / "step_15.npz") as f:
            keys[pkg] = sorted(f.files)
    with np.load(tmp_path / "first" / "step_10.npz") as f:
        assert sorted(f.files) == keys["repro"] == keys["port"]


def _reference_example():
    path = Path(__file__).resolve().parents[1] / "examples" / "async_embeddings_for_llm.py"
    spec = importlib.util.spec_from_file_location("ref_async_embeddings_for_llm", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.usefixtures("one_torch_thread")
def test_llm_example_batches_and_train_lm_match_the_reference():
    import jax
    from repro.configs import get_config as jget_config
    from repro.data.corpus import SemanticCorpusModel as JCorpusModel
    from repro.models import Model as JaxModel
    from repro_torch import convert
    from repro_torch.configs import get_config
    from repro_torch.data.corpus import SemanticCorpusModel
    from repro_torch.examples import async_embeddings_for_llm as ex

    ref = _reference_example()
    jcorpus = JCorpusModel.create(vocab_size=512, seed=0).generate(num_sentences=400, seed=1)
    corpus = SemanticCorpusModel.create(vocab_size=512, seed=0).generate(num_sentences=400,
                                                                         seed=1)
    ours_b = list(ex.make_lm_batches(corpus, 512, 8, 48, 5))
    for a, b in zip(ours_b, ref.make_lm_batches(jcorpus, 512, 8, 48, 5)):
        assert a.dtype == np.int32
        np.testing.assert_array_equal(a, np.asarray(b))
    jcfg = jget_config("smollm-360m").reduced()
    params = JaxModel(jcfg).init(jax.random.PRNGKey(0))
    model = convert.from_jax_model_params(get_config("smollm-360m").reduced(),
                                          jax.tree.map(np.asarray, params))
    ours = ex.train_lm(model, corpus, steps=3)
    np.testing.assert_allclose(ours, ref.train_lm(jcfg, params, jcorpus, steps=3), rtol=1e-5)


# ---------------------------------------------------------------------------
# The LLM CLIs on the archs of slice 14: an MoE, an SSM, the encoder-decoder
# ---------------------------------------------------------------------------
ZOO_CLI_ARCHS = ("qwen3-moe-30b-a3b", "xlstm-1.3b", "seamless-m4t-large-v2")


@pytest.mark.usefixtures("one_torch_thread")
@pytest.mark.parametrize("arch", ZOO_CLI_ARCHS)
def test_decode_llm_cli_prints_the_reference_tokens(arch):
    """``python -m repro_torch.launch.decode_llm --arch A --reduced`` at the
    reference CLI's defaults (batch 4, prompt 16, 32 new tokens): the same
    shape line and the same first sequence (greedy tokens from the same
    seed; the encoder-decoder's zero frames encoded first)."""
    from repro.launch import decode_llm as jdecode
    from repro_torch.launch import decode_llm as tdecode

    ours = _run(tdecode.main, ["--arch", arch, "--reduced", "--device", "cpu"]).splitlines()
    ref = _run(jdecode.main, ["--arch", arch, "--reduced"]).splitlines()
    assert ours[0].startswith("generated (4, 32) tokens;")
    assert ref[0].startswith("generated (4, 32) tokens;")
    assert ours[1] == ref[1] and ours[1].startswith("first sequence: [")


def _final_losses(text: str):
    line = [ln for ln in text.splitlines() if ln.startswith("final loss")][-1]
    final, first = line.removeprefix("final loss ").split(" (first ")
    return float(final), float(first.rstrip(")"))


@pytest.mark.usefixtures("one_torch_thread")
@pytest.mark.parametrize("arch", ZOO_CLI_ARCHS)
def test_train_cli_prints_the_reference_losses(arch):
    """``python -m repro_torch.launch.train --arch A --reduced`` for 3 steps
    of 2 × 16 tokens (the encoder-decoder with 16 zero frames): each
    package from its own init (the same keys; ``normal`` differs in the
    last ulps), so the printed 4-decimal losses agree within one unit of
    their last digit, plus the launcher steps' rtol of
    ``test_torch_arch_zoo.py`` (xlstm-1.3b's AdamW steps 1e-4: measured
    3.1e-5 here)."""
    from test_torch_arch_zoo import STEP_RTOL

    argv = ["--arch", arch, "--reduced", "--steps", "3", "--batch", "2", "--seq", "16"]
    ours = _final_losses(_run(tlm.main, argv + ["--device", "cpu"]))
    ref = _final_losses(_run(jlm.main, argv))
    np.testing.assert_allclose(ours, ref, rtol=STEP_RTOL.get(arch, 1e-5), atol=1e-4 + 1e-9)
