"""The port's package surfaces against the JAX package's: every name in the
``__all__`` of ``repro.core``, ``repro.data``, ``repro.eval``,
``repro.kernels`` and ``repro.analysis`` resolves on the same package of
``repro_torch`` to its counterpart, whose parameters include the
reference's (apart from the TPU-only or JAX-only ones in
:data:`DROPPED`, each with its reason), constants holding the reference's
values (the renamed ones in :data:`RENAMED`); the names that exist only as
exports (``merge_embeddings``, ``FoldResult``, the sampler contracts, the
sliding-window contracts) computed as the reference computes them: ids
bitwise, attention within 1e-5."""

import importlib
import inspect

import jax
import numpy as np
import pytest
import torch

PACKAGES = ("core", "data", "eval", "kernels", "analysis")

#: Reference parameters the port's counterpart does not take, by export
#: (``package.name``), with the reason. A name absent on the port would go
#: in this table too; none is.
DROPPED = {
    "core.AsyncShardTrainer": ({"backend", "mesh"},
                               "a jax backend and Mesh: the port takes a torch device, "
                               "and several processes through torch.distributed"),
    "core.make_sync_epoch": ({"mesh", "data_axis"},
                             "a jax Mesh and its axis: the port takes a process group"),
    "core.assert_no_collectives": ({"lowered"},
                                   "lowered StableHLO: the port counts the c10d ops a "
                                   "call dispatches (torch has no HLO)"),
    "core.count_collective_ops": ({"hlo_text"},
                                  "HLO text: the port profiles a call instead"),
    "data.prefetch_chunks": ({"to_device"},
                             "a jax device_put callable: the port takes a torch device"),
    "kernels.sgns_row_grads": ({"interpret", "block_b"},
                               "Pallas dials: interpret mode and the VMEM block"),
    "kernels.sgns_apply_step": ({"interpret"}, "Pallas interpret mode"),
    "kernels.make_row_grad_fn": ({"interpret", "block_b"},
                                 "Pallas dials: interpret mode and the VMEM block"),
    "kernels.sgns_fused_step": ({"key", "interpret"},
                                "one jax key: the port's K2 takes the (n, 2) seeds of n "
                                "workers; Pallas interpret mode"),
    "kernels.sample_negatives_fused": ({"interpret"}, "Pallas interpret mode"),
    "kernels.swa_decode_kernel": ({"interpret"}, "Pallas interpret mode"),
}


#: Reference constants whose values the port renames, with the mapping.
RENAMED = {
    "core.ENGINE_NAMES": ({"pallas": "rowgrad", "pallas_fused": "fused",
                           "pallas_fused_hbm": "fused_hbm", "pallas_fused_pipe": "fused_pipe",
                           "pallas_fused_tiered": "fused_tiered"},
                          "the engines are named for the kernels they run, not for Pallas"),
}


def _exports():
    for pkg in PACKAGES:
        ref = importlib.import_module(f"repro.{pkg}")
        for name in ref.__all__:
            yield pkg, name


@pytest.mark.parametrize("pkg,name", list(_exports()), ids=lambda v: str(v))
def test_every_reference_export_resolves_on_the_port(pkg, name):
    ref_pkg = importlib.import_module(f"repro.{pkg}")
    port_pkg = importlib.import_module(f"repro_torch.{pkg}")
    assert name in port_pkg.__all__, f"repro_torch.{pkg}.__all__ lacks {name}"
    got = getattr(port_pkg, name)
    want = getattr(ref_pkg, name, None)
    if want is None:                        # a submodule name (repro.analysis)
        want = importlib.import_module(f"repro.{pkg}.{name}")
    if inspect.ismodule(want):
        assert inspect.ismodule(got) and got.__name__ == f"repro_torch.{pkg}.{name}"
        return
    if not callable(want):                  # a constant: the same names or values
        renamed = RENAMED.get(f"{pkg}.{name}", ({}, ""))[0]
        assert type(got) is type(want)
        assert sorted(map(str, got)) == sorted(renamed.get(str(w), str(w)) for w in want)
        return
    assert callable(got) and got.__module__.startswith("repro_torch.")
    if inspect.isclass(want):
        assert inspect.isclass(got) and got.__name__ == want.__name__
    ref_params = set(inspect.signature(want).parameters)
    port_params = set(inspect.signature(got).parameters)
    dropped = DROPPED.get(f"{pkg}.{name}", (set(), ""))[0]
    assert ref_params - port_params == dropped, (
        f"{pkg}.{name}: the port lacks {sorted(ref_params - port_params)}; "
        f"the exception table names {sorted(dropped)}")


def test_the_exception_tables_name_only_exports_with_reasons():
    names = {f"{p}.{n}" for p, n in _exports()}
    for key, (changed, reason) in {**DROPPED, **RENAMED}.items():
        assert key in names and changed and len(reason) > 10, key


def test_fold_result_and_merge_embeddings():
    import repro_torch.core as core
    from repro_torch.core import merge as merge_module

    assert inspect.ismodule(merge_module)
    assert core.merge_embeddings is merge_module.merge
    assert merge_module.FoldResult is merge_module.MergeResult
    assert core.MergeResult is merge_module.FoldResult
    assert inspect.ismodule(importlib.import_module("repro_torch.core.merge"))
    assert core.merge is merge_module          # the attribute stays the submodule


KEYS_AND_SHAPES = ((3, (8, 5)), (0, (7,)), (12, (33, 3)), (2**31 + 5, (4, 2, 5)))


def _tables():
    from repro.data.pairs import build_noise_table as j_build_table
    from repro_torch.data.pairs import build_noise_table as t_build_table

    counts = np.random.default_rng(7).zipf(1.3, 64).astype(np.float64)
    return j_build_table(counts, kind="alias"), t_build_table(counts, kind="alias")


@pytest.mark.parametrize("seed,shape", KEYS_AND_SHAPES)
def test_sample_negatives_fused_is_the_references_draw(seed, shape):
    """The reference's sampler contract ``(table, key, shape)``: its
    interpret-mode Pallas sampler's ids, bitwise, on the same table and
    key (the key as uint32 words and as a tensor of their bits)."""
    from repro.kernels import sample_negatives_fused as j_sample
    from repro_torch.kernels import sample_negatives_fused

    jt, tt = _tables()
    key = jax.random.PRNGKey(seed)
    want = np.asarray(j_sample(jt, key, shape, interpret=True))
    words = np.asarray(key)
    for k in (words, torch.from_numpy(words.view(np.int32).copy())):
        got = sample_negatives_fused(tt, k, shape)
        assert got.dtype == torch.int32 and tuple(got.shape) == shape
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("seed,shape", KEYS_AND_SHAPES)
def test_fused_negative_ids_is_the_references_replay(seed, shape):
    from repro.kernels import fused_negative_ids as j_ids
    from repro_torch.kernels import fused_negative_ids

    jt, tt = _tables()
    key = jax.random.PRNGKey(seed)
    want = np.asarray(j_ids(key, jt["prob"], jt["alias"], shape))
    got = fused_negative_ids(np.asarray(key), tt["prob"], tt["alias"], shape)
    np.testing.assert_array_equal(got.numpy(), want)


# (B, W, H, D, chunk) of tests/test_kernels.py's window cases, Hkv == H
SWA_CASES = [(2, 256, 4, 64, 64), (3, 128, 2, 32, 32)]


@pytest.mark.parametrize("B,W,H,D,chunk", SWA_CASES)
def test_swa_decode_contracts_match_the_references(B, W, H, D, chunk):
    import jax.numpy as jnp
    from repro.kernels import swa_decode_kernel as j_kernel
    from repro.kernels import swa_decode_ref as j_ref
    from repro_torch.kernels import swa_decode_kernel, swa_decode_ref

    rng = np.random.default_rng(B * 1000 + W)
    q = (rng.standard_normal((B, H, D)) * 0.5).astype(np.float32)
    k = (rng.standard_normal((B, W, H, D)) * 0.5).astype(np.float32)
    v = (rng.standard_normal((B, W, H, D)) * 0.5).astype(np.float32)
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    np.testing.assert_allclose(swa_decode_ref(tq, tk, tv).numpy(),
                               np.asarray(j_ref(jq, jk, jv)), atol=1e-5, rtol=0)
    np.testing.assert_allclose(swa_decode_kernel(tq, tk, tv, chunk=chunk).numpy(),
                               np.asarray(j_kernel(jq, jk, jv, chunk=chunk, interpret=True)),
                               atol=1e-5, rtol=0)
